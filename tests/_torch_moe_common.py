"""Shared by the MoE and VLM parity tests (``test_torch_moe.py`` and
``test_torch_moe_engine.py``): the smoke configs with the reference's
parameters bridged, and a numpy-to-torch helper."""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtfm
from repro.training.checkpoint import _flatten
from repro_torch import bridge
from repro_torch.configs import get_smoke_config

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["olmoe_1b_7b", "moonshot_v1_16b_a3b", "kimi_k2_1t_a32b",
         "qwen2_vl_72b"]


def _with_capacity(cfg, cf):
    if cf is None or cfg.moe is None:
        return cfg
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


_BRIDGED = {}


def _bridged(arch, cf=None):
    """(jcfg, jparams, cfg, params): f32 smoke configs at a 2048 vocab, the
    reference's parameters bridged; ``cf`` overrides the capacity factor."""
    if (arch, cf) not in _BRIDGED:
        jcfg = _with_capacity(jax_smoke_config(arch).replace(
            dtype="float32", vocab_size=2048), cf)
        cfg = _with_capacity(get_smoke_config(arch).replace(
            dtype="float32", vocab_size=2048), cf)
        jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
        _BRIDGED[arch, cf] = (jcfg, jparams, cfg, bridge.params_from_flat(
            _flatten(jparams), device="cpu"))
    return _BRIDGED[arch, cf]


def _t(x):
    return torch.from_numpy(np.array(x))
