"""Streamlit web app home page (reference: web_app/home.py).

Run with:  streamlit run web_app/home.py
Requires `pip install streamlit` (optional extra `placement-tpu[webapp]`).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

try:
    import streamlit as st
except ImportError as e:  # pragma: no cover - optional dependency
    raise SystemExit(
        "The web app needs streamlit (pip install streamlit); the core "
        "framework does not depend on it.") from e

st.set_page_config(page_title="RL Component Placement", page_icon="🔲",
                   layout="wide")

st.title("RL Component Placement")
st.markdown(
    """
A JAX reinforcement-learning framework for PCB component placement.

Use the pages in the sidebar:

1. **Trained agents** — browse past training runs, their configs, learning
   curves, and replay placement rollouts.
2. **Train new agent** — configure environment and model hyperparameters and
   launch a PPO training run on-device, with live reward curves.
3. **Comparison analysis** — overlay reward / wirelength / intersection
   curves across runs.

The environment suite has four variants of increasing complexity — square,
rectangular, rectangular-with-pins, and pin-spatial — all implemented as one
batched, jit-compiled functional stepper (see `placement_tpu/env/`).
"""
)
