"""The ten reference policy architectures as one configurable model.

Reference classes (agent/models/) -> presets here (registry names match
utils/agent/utils.py:62-74):

  square                              SquareModel (square_model.py:14)
  rectangle                           RectangleModel (rectangle_model.py:13)
  rectangle_factorized                RectangleFactorizedModel (rectangle_model_factorized.py:12)
  rectangle_pin                       RectanglePinModel (rectangle_pin_model.py:13)
  rectangle_pin_attn_component        RectanglePinAttnCompModel
  rectangle_pin_attn_all              RectanglePinAttnCompPinModel
  rectangle_factorized_pin            RectanglePinFactorizedModel
  rectangle_pin_all_attn_factorized   RectanglePinAllAttnFactorized
  rectangle_pin_attn_all_no_grid      RectanglePinAttnAllNoGridModel
  rectangle_spatial_pin               RectanglePinSpatialModel

All observations arrive batched [B, ...] in the env's obs-dict layout.
Joint-head presets return masked logits over the flattened (orientation, x,
y) action space plus a value; factorized presets return the encoding plus a
value, with per-factor logit heads exposed as extra methods for the
factorized action distributions.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from placement_tpu.models.blocks import (Scope, attention, batch_norm,
                                         conv_blocks, dense, mask_logits,
                                         self_attention)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Union of the reference's custom_model_config fields
    (agent/config/*.json)."""

    model_type: str = "rectangle_pin"
    height: int = 10
    width: int = 10
    num_orientations: int = 4
    max_num_components: int = 5
    max_num_nets: int = 3
    max_num_pins_per_component: int = 4
    component_feature_vector_width: int = 5
    pin_feature_vector_width: int = 8
    num_conv_blocks: int = 2
    num_conv_filters: int = 3
    conv_kernel_size: int = 3
    activation: str = "relu"
    max_pool: bool = False
    max_pool_kernel_size: int = 2
    component_feature_encoding_dimension: int = 16
    pin_feature_encoding_dimension: int = 16
    attn_hidden_size: int = 16
    attn_hidden_size_pin: int = 16
    # spatial-model extras (rectangle_pin_spatial_model config)
    num_conv_blocks_component_grid: int = 1
    num_conv_filters_component_grid: int = 3
    conv_kernel_size_component_grid: int = 3
    activation_component_grid: str = "relu"
    max_pool_component_grid: bool = False
    max_pool_kernel_size_component_grid: int = 3
    conv_padding_component_grid: str = "SAME"
    component_attn_hidden_size: int = 16
    # factorized extras
    factorization: str = "orientation"  # "orientation" | "coordinates"
    use_batch_norm: bool = True

    @property
    def is_factorized(self) -> bool:
        return self.model_type in ("rectangle_factorized",
                                   "rectangle_factorized_pin",
                                   "rectangle_pin_all_attn_factorized")

    @property
    def num_actions(self) -> int:
        if self.model_type == "square":
            return self.height * self.width
        return self.num_orientations * self.height * self.width


_ATTN_PIN_TYPES = ("rectangle_pin_attn_all", "rectangle_pin_attn_all_no_grid",
                   "rectangle_pin_all_attn_factorized")
_ATTN_COMP_TYPES = ("rectangle_pin_attn_component",) + _ATTN_PIN_TYPES


@dataclasses.dataclass(frozen=True)
class PlacementModel:
    """One model, ten presets — encoder chosen by cfg.model_type.

    Variables are ``{"params": ..., "batch_stats": ...}`` keyed by the layer
    names below (``grid_conv``, ``component_dense``, ``logits_head``...).
    A layer that the preset never calls has no variables.
    """

    cfg: ModelConfig

    # -- public entry points -------------------------------------------------

    def init(self, key, obs) -> dict:
        """Create every variable of the preset from a sample batch,
        including the factorized heads, which only the action distribution
        calls otherwise."""
        s = Scope.initializing(key)
        out = self._forward(s, obs)
        if self.cfg.is_factorized:
            enc = out["encoding"]
            b = enc.shape[0]
            oh = jnp.zeros((b, self.cfg.num_orientations), enc.dtype)
            xn = jnp.zeros((b,), enc.dtype)
            self._o_logits(s, enc, xn, xn)
            self._x_logits(s, enc, oh)
            self._y_logits(s, enc, oh, xn)
        return s.variables

    def apply(self, variables, obs, train: bool = False) -> tuple:
        """-> (outputs, updates). In train mode batch norm uses the batch's
        statistics and ``updates`` holds the new ``batch_stats``; otherwise
        ``updates`` is empty."""
        s = Scope.bound(variables, train=train)
        return self._forward(s, obs), s.updates

    # factorized heads (rectangle_model_factorized.py:133-311)
    def o_logits(self, variables, enc, x_norm=None, y_norm=None
                 ) -> jnp.ndarray:
        return self._o_logits(Scope.bound(variables), enc, x_norm, y_norm)

    def x_logits(self, variables, enc, onehot_o=None) -> jnp.ndarray:
        return self._x_logits(Scope.bound(variables), enc, onehot_o)

    def y_logits(self, variables, enc, onehot_o=None, x_norm=None
                 ) -> jnp.ndarray:
        return self._y_logits(Scope.bound(variables), enc, onehot_o, x_norm)

    # -- encoders ----------------------------------------------------------

    def _conv_blocks(self, s, x):
        """The grid conv stack (``grid_conv`` and ``pin_grid_conv``)."""
        cfg = self.cfg
        return conv_blocks(
            s, x, cfg.num_conv_blocks, cfg.num_conv_filters,
            cfg.conv_kernel_size, cfg.activation,
            cfg.max_pool_kernel_size if cfg.max_pool else 0,
            use_batch_norm=cfg.use_batch_norm)

    def _encode_grid(self, s, grid):
        x = self._conv_blocks(s.child("grid_conv"), grid)
        return x.reshape(x.shape[0], -1)

    def _encode_rect_features(self, s, obs):
        """RectangleModel.preprocess + encode_flattened_component_feature
        (rectangle_model.py:104-163): zero placed components, flatten,
        Dense+BN+relu."""
        feat = obs["all_components_feature"]
        keep = (obs["placement_mask"] == 0).astype(feat.dtype)
        masked = feat * keep[..., None]
        x = masked.reshape(masked.shape[0], -1)
        x = dense(s.child("flat_feature_dense"), x,
                  self.cfg.component_feature_encoding_dimension)
        x = batch_norm(s.child("flat_feature_norm"), x)
        return jax.nn.relu(x)

    def _pin_tokens(self, obs):
        """One-hot the pin net id and concat with numeric features
        (rectangle_pin_model.py:234-287) -> [B, C, ppc, 4 + nets + 1]."""
        num = obs["all_pins_num_feature"]
        cat = obs["all_pins_cat_feature"][..., 0].astype(jnp.int32)
        onehot = jax.nn.one_hot(cat, self.cfg.max_num_nets + 1,
                                dtype=num.dtype)
        return jnp.concatenate([num, onehot], axis=-1)

    def _encode_pin_components(self, s, obs):
        """RectanglePinModel encoding stack -> [B, C, D] token matrix
        (rectangle_pin_model.py:132-232)."""
        cfg = self.cfg
        comp_enc = dense(s.child("component_dense"),
                         obs["all_components_feature"],
                         cfg.component_feature_encoding_dimension)
        pins = self._pin_tokens(obs)                       # [B, C, ppc, F]
        pin_enc = dense(s.child("pin_dense"), pins,
                        cfg.pin_feature_encoding_dimension)  # [B, C, ppc, E]
        if cfg.model_type in _ATTN_PIN_TYPES:
            # per-component pin self-attention, flattened
            # (rectangle_pin_attn_component_pin_model.py:120-171)
            q, k, v = (dense(s.child(name), pin_enc, cfg.attn_hidden_size_pin)
                       for name in ("pin_q", "pin_k", "pin_v"))
            att = attention(q, k, v)
            pin_pooled = att.reshape(att.shape[0], att.shape[1], -1)
        else:
            # shared dense then sum-pool over pins (:186-217)
            pin_pooled = jnp.sum(pin_enc, axis=2)
        mask_onehot = jax.nn.one_hot(
            obs["placement_mask"].astype(jnp.int32), 4, dtype=comp_enc.dtype)
        tokens = jnp.concatenate([comp_enc, pin_pooled, mask_onehot], axis=-1)
        if cfg.model_type in _ATTN_COMP_TYPES:
            tokens = self_attention(s.child("comp_attn"), tokens,
                                    cfg.attn_hidden_size)
        return tokens

    def _encode_spatial(self, s, obs):
        """RectanglePinSpatialModel encodings
        (rectangle_pin_spatial_model.py:95-230)."""
        b = obs["grid"].shape[0]
        ge = self._encode_grid(s, obs["grid"])
        pe = self._conv_blocks(s.child("pin_grid_conv"), obs["pin_grid"])
        pe = pe.reshape(b, -1)
        cgrid = obs["component_grid"]                      # [B, C, h, w, ch]
        bc = cgrid.reshape((-1,) + cgrid.shape[2:])
        cfg = self.cfg
        ce = conv_blocks(
            s.child("component_grid_conv"), bc,
            cfg.num_conv_blocks_component_grid,
            cfg.num_conv_filters_component_grid,
            cfg.conv_kernel_size_component_grid,
            cfg.activation_component_grid,
            (cfg.max_pool_kernel_size_component_grid
             if cfg.max_pool_component_grid else 0),
            padding=cfg.conv_padding_component_grid.upper(),
            use_batch_norm=cfg.use_batch_norm)
        ce = ce.reshape(b, cgrid.shape[1], -1)
        mask_onehot = jax.nn.one_hot(
            obs["placement_mask"].astype(jnp.int32), 4, dtype=ce.dtype)
        tokens = jnp.concatenate([ce, mask_onehot], axis=-1)
        tokens = self_attention(s.child("spatial_comp_attn"), tokens,
                                cfg.component_attn_hidden_size)
        return jnp.concatenate([ge, pe, tokens.reshape(b, -1)], axis=-1)

    def _encode(self, s, obs) -> jnp.ndarray:
        """Full encoding vector for the configured preset."""
        t = self.cfg.model_type
        if t == "square":
            return self._encode_grid(s, obs["grid"])
        if t in ("rectangle", "rectangle_factorized"):
            ge = self._encode_grid(s, obs["grid"])
            fe = self._encode_rect_features(s, obs)
            return jnp.concatenate([ge, fe], axis=-1)
        if t == "rectangle_spatial_pin":
            return self._encode_spatial(s, obs)
        tokens = self._encode_pin_components(s, obs)
        flat = tokens.reshape(tokens.shape[0], -1)
        if t == "rectangle_pin_attn_all_no_grid":
            # drops the grid encoding (rectangle_pin_attn_all_model_no_grid.py:63-64)
            return flat
        ge = self._encode_grid(s, obs["grid"])
        return jnp.concatenate([ge, flat], axis=-1)

    # -- heads -------------------------------------------------------------

    def _forward(self, s, obs):
        enc = self._encode(s, obs)
        value = dense(s.child("value_head"), enc, 1)[..., 0]
        if self.cfg.is_factorized:
            return {"encoding": enc, "value": value}
        logits = dense(s.child("logits_head"), enc, self.cfg.num_actions)
        flat_mask = obs["action_mask"].reshape(logits.shape[0], -1)
        return {"logits": mask_logits(logits, flat_mask), "value": value}

    def _o_logits(self, s, enc, x_norm, y_norm):
        head = s.child("orientation_head")
        n = self.cfg.num_orientations
        if self.cfg.factorization == "orientation":
            return dense(head, enc, n)
        return dense(head, jnp.concatenate(
            [enc, x_norm[..., None], y_norm[..., None]], -1), n)

    def _x_logits(self, s, enc, onehot_o):
        head = s.child("x_head")
        if self.cfg.factorization == "orientation":
            return dense(head, jnp.concatenate([enc, onehot_o], -1),
                         self.cfg.height)
        return dense(head, enc, self.cfg.height)

    def _y_logits(self, s, enc, onehot_o, x_norm):
        head = s.child("y_head")
        if self.cfg.factorization == "orientation":
            return dense(head, jnp.concatenate(
                [enc, onehot_o, x_norm[..., None]], -1), self.cfg.width)
        return dense(head, jnp.concatenate([enc, x_norm[..., None]], -1),
                     self.cfg.width)


MODEL_REGISTRY = (
    "square", "rectangle", "rectangle_factorized", "rectangle_pin",
    "rectangle_pin_attn_component", "rectangle_pin_attn_all",
    "rectangle_factorized_pin", "rectangle_pin_all_attn_factorized",
    "rectangle_pin_attn_all_no_grid", "rectangle_spatial_pin")


def build_model(cfg: ModelConfig) -> PlacementModel:
    if cfg.model_type not in MODEL_REGISTRY:
        raise KeyError(f"unknown model type {cfg.model_type!r}")
    return PlacementModel(cfg)
