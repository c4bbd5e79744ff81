"""Policy-network zoo mirroring the reference's ten architectures
(agent/models/*, registry utils/agent/utils.py:62-86)."""

from placement_tpu.models.zoo import (  # noqa: F401
    MODEL_REGISTRY,
    ModelConfig,
    build_model,
)
