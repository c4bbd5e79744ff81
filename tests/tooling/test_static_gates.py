"""Static-analysis gate (reference parity: /root/reference/setup.cfg:1-4).

The reference CI runs flake8 (line length, cognitive complexity) and mypy;
neither is installed in this image, so tools/lint.py implements equivalent
checks with the stdlib and this test makes them a hard gate.
"""

import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO / "tools"))


def test_source_tree_is_lint_clean():
    import lint
    errors = lint.run([REPO / "placement_tpu", REPO / "tools",
                       REPO / "experiments", REPO / "bench.py",
                       REPO / "__graft_entry__.py", REPO / "chip_smoke.py"])
    assert errors == []


def test_source_tree_passes_type_gate():
    """The mypy stand-in (tools/typecheck.py): public-API return
    annotations + dataclass attribute/constructor validation."""
    import typecheck
    errors = typecheck.run([REPO / "placement_tpu"])
    assert errors == []


def test_type_gate_detects_violations(tmp_path):
    """The gate itself must catch what it claims to: a missing return
    annotation, an attribute typo on EnvParams, and a bad constructor
    keyword."""
    import typecheck
    bad = tmp_path / "bad_module.py"
    bad.write_text(
        "from placement_tpu.env.types import EnvParams\n"
        "def no_annotation(params: EnvParams):\n"
        "    return params.max_componets\n"          # typo'd attribute
        "def make() -> EnvParams:\n"
        "    return EnvParams(heigth=10)\n"           # typo'd field
        "def tweak(params: EnvParams) -> EnvParams:\n"
        "    return params.replace(widht=3)\n")       # typo'd replace kw
    # check_file operates on REPO-relative paths; route through run() with
    # a temp copy living outside REPO via monkeypatched REPO root
    old = typecheck.REPO
    try:
        typecheck.REPO = tmp_path
        errors = typecheck.run([bad])
    finally:
        typecheck.REPO = old
    joined = "\n".join(errors)
    assert "lacks a return annotation" in joined
    assert "no attribute 'max_componets'" in joined
    assert "heigth" in joined
    assert "no field 'widht'" in joined
