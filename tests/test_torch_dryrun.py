"""The port's dry-run: steps traced on ``meta`` tensors under DTensor over a
placeholder process group, and the per-device counts they give.

Twins of ``tests/test_dryrun_plumbing.py`` (train and decode steps on a
(1, 1) mesh), the cost counter's exact cases (a sharded product on the
fake (16, 16) mesh, layer extrapolation), the port's FLOPs against the
reference's ``analyze_hlo`` on the same step, the copied ``hlo_cost`` on
JAX-produced text, and one combination at (16, 16).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.analysis import analyze, model_flops_estimate
from repro_torch.launch.cost import CostMode
from repro_torch.launch.hlo_cost import analyze_hlo
from repro_torch.launch.mesh import (make_cpu_mesh, make_production_mesh,
                                     placeholder_world)
from repro_torch.launch.dryrun import at_depth, step_cost, trace_step

TRAIN = InputShape("smoke_train", 32, 2, "train")


def _smoke(arch):
    return get_smoke_config(arch).replace(dtype="float32")


# ------------------------------------------------------- plumbing (twins)
# FLOPs of the port's (1, 1) step against the reference's analyze_hlo of the
# same step (microbatch 2, remat none, 2 x 32), measured at these shapes:
# 0.993, 0.954, 0.969, 0.989 of it. The gaps that remain: the reference's
# MoE dispatch and combine are one-hot einsums over (G, T, E, C), counted
# as products, where the port indexes; its elementwise ops are XLA's (a
# fused silu, a logistic that hlo_cost does not count), the port's aten's.
FLOP_TOLERANCE = {"llama3_2_3b": 0.02, "olmoe_1b_7b": 0.08,
                  "rwkv6_7b": 0.04, "hymba_1_5b": 0.02}


def _reference_step_flops(arch, microbatch):
    from jax.sharding import Mesh

    from repro.configs import get_smoke_config as ref_smoke
    from repro.launch.hlo_cost import analyze_hlo as ref_analyze
    from repro.models import transformer as rtfm
    from repro.models.model import example_batch
    from repro.sharding.annotate import DEFAULT_RULES, logical_axis_rules
    from repro.sharding.specs import batch_specs, param_specs, replicated
    from repro.training.optimizer import Adam
    from repro.training.train_loop import make_train_step

    cfg = ref_smoke(arch).replace(dtype="float32")
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    p_shape = jax.eval_shape(
        lambda: rtfm.init_params(jax.random.PRNGKey(0), cfg))
    opt = Adam(learning_rate=1e-4, clip_norm=1.0)
    o_shape = jax.eval_shape(opt.init, p_shape)
    o_specs = type(o_shape)(step=replicated(mesh),
                            mu=param_specs(o_shape.mu, mesh),
                            nu=param_specs(o_shape.nu, mesh))
    b_shape = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in
               example_batch(cfg, TRAIN.global_batch, TRAIN.seq_len,
                             jax.random.PRNGKey(1)).items()}
    with mesh, logical_axis_rules(mesh, DEFAULT_RULES):
        step = make_train_step(cfg, opt, remat="none", microbatch=microbatch)
        compiled = jax.jit(step, in_shardings=(param_specs(p_shape, mesh),
                                               o_specs,
                                               batch_specs(b_shape, mesh)),
                           ).lower(p_shape, o_shape, b_shape).compile()
    return ref_analyze(compiled.as_text()).flops


@pytest.mark.parametrize("arch", list(FLOP_TOLERANCE))
def test_train_step_traces_on_mesh(arch):
    """The train step traces on a (1, 1) mesh with microbatch 2, and its
    FLOPs stand within the stated tolerance of the reference's
    ``analyze_hlo`` on the same step."""
    cfg = _smoke(arch)
    with placeholder_world(1):
        cost = trace_step(cfg, TRAIN, make_cpu_mesh(), remat="none",
                          microbatch=2)
    rl = analyze(cost, arch=arch, shape="smoke", mesh_name="cpu1x1",
                 n_devices=1, model_flops=model_flops_estimate(cfg, TRAIN))
    assert rl.flops_per_device > 0
    assert rl.bytes_per_device > 0
    assert rl.memory_gb_per_device > 0
    assert rl.bottleneck in ("compute", "memory", "collective")
    assert not dist.is_initialized()
    ref = _reference_step_flops(arch, microbatch=2)
    assert abs(cost.flops / ref - 1) <= FLOP_TOLERANCE[arch], cost.flops / ref


def test_decode_step_traces_with_cache_specs():
    cfg = _smoke("llama3_2_3b")
    shape = InputShape("smoke_decode", 128, 2, "decode")
    costs = {}
    with placeholder_world(1):
        for kv_shard in ("heads", "seq"):
            costs[kv_shard] = trace_step(cfg, shape, make_cpu_mesh(),
                                         kv_shard=kv_shard)
    # one rank: both layouts are the whole cache
    assert costs["heads"].flops == costs["seq"].flops > 0


# ------------------------------------------------------- cost counting
def test_sharded_matmul_counts_per_device_flops_and_its_all_gather():
    """x (256, 64, 512) split on batch over data; w (512, 1024) split on its
    rows over data (FSDP) and its columns over model: each rank gathers
    its w columns over data and multiplies its own rows."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    b, s, d, f = 256, 64, 512, 1024
    with placeholder_world(256):
        mesh = make_production_mesh()
        x = DTensor.from_local(torch.empty(b // 16, s, d, device="meta",
                                           dtype=torch.bfloat16), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(d // 16, f // 16, device="meta",
                                           dtype=torch.bfloat16), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        with CostMode() as mode:
            y = x @ w
        assert tuple(y.to_local().shape) == (b // 16, s, f // 16)
    assert not dist.is_initialized()
    assert mode.cost.flops == 2 * b * s * d * f / 256
    assert mode.cost.collectives["all-gather"] == d * (f // 16) * 2
    assert mode.cost.collective_bytes == d * (f // 16) * 2


def test_cost_mode_counts_bytes_of_non_views_and_live_peak():
    x = torch.empty(1024, device="meta")
    with CostMode() as mode:
        mode.track(x)
        y = x.view(32, 32)                    # a view: nothing moved
        z = y * 2.0                           # 4 KiB in, 4 KiB out
        del z
        w = (y + 1.0).sum()
    # mul and add: 4 KiB in, 4 KiB out each; sum: 4 KiB in, 4 B out
    assert mode.cost.bytes == 2 * 8192 + 4096 + 4
    assert mode.cost.flops == 2 * 1024      # mul and add, not sum
    # x with z, then x with y + 1 and its sum
    assert mode.cost.peak_bytes == 2 * 4096 + 4
    assert w.shape == ()


@pytest.mark.parametrize("arch,depth,kind", [
    ("llama3_2_3b", (4,), "train"),          # forward, backward, Adam
    ("whisper_tiny", (3, 4), "prefill"),     # encoder and decoder stacks
])
def test_layer_extrapolation_equals_a_full_trace(arch, depth, kind):
    """Traces at 1 and 2 layers per stack, extended linearly, equal a trace
    at the full depth: FLOPs, bytes and collectives exactly, on a (2, 1)
    mesh where the batch and the FSDP dims are split (each layer's
    gradients placed as its parameters, ``annotate.gather_fsdp``)."""
    cfg = at_depth(_smoke(arch), depth)
    shape = InputShape("smoke", 16, 4, kind)
    from torch.distributed.device_mesh import init_device_mesh
    with placeholder_world(2):
        mesh = init_device_mesh("cpu", (2, 1),
                                mesh_dim_names=("data", "model"))
        full = trace_step(cfg, shape, mesh, remat="none")
        extended, _ = step_cost(cfg, shape, mesh, remat="none")
    assert full.collective_bytes > 0
    assert extended.flops == full.flops
    assert extended.bytes == full.bytes
    assert extended.collectives == full.collectives
    if len(depth) == 1:
        # a decoder's peak is linear too; an encoder's output stays live
        # across the decoder, so the encoder-decoder peak is not
        assert extended.peak_bytes == full.peak_bytes


# ------------------------------------------------------- hlo_cost copy
def test_copied_hlo_cost_single_matmul():
    txt = (jax.jit(lambda x, w: x @ w)
           .lower(jnp.zeros((128, 128)), jnp.zeros((128, 128)))
           .compile().as_text())
    assert analyze_hlo(txt).flops == pytest.approx(2 * 128 ** 3, rel=0.01)


def test_copied_hlo_cost_scan_trip_count():
    def scanned(x, ws):
        def body(c, w):
            return c @ w, None
        return jax.lax.scan(body, x, ws)[0]
    txt = (jax.jit(scanned)
           .lower(jnp.zeros((128, 128)), jnp.zeros((10, 128, 128)))
           .compile().as_text())
    assert analyze_hlo(txt).flops == pytest.approx(10 * 2 * 128 ** 3,
                                                   rel=0.01)


def test_copied_hlo_cost_nested_scan():
    def nested(x, ws):
        def outer(c, wrow):
            def inner(c2, w):
                return c2 @ w, None
            return jax.lax.scan(inner, c, wrow)[0], None
        return jax.lax.scan(outer, x, ws)[0]
    txt = (jax.jit(nested)
           .lower(jnp.zeros((128, 128)), jnp.zeros((3, 5, 128, 128)))
           .compile().as_text())
    assert analyze_hlo(txt).flops == pytest.approx(15 * 2 * 128 ** 3,
                                                   rel=0.01)


def test_collective_bytes_reads_hlo_text_as_the_reference():
    from repro.launch.analysis import collective_bytes as ref
    from repro_torch.launch.analysis import collective_bytes
    txt = ("%all-gather.3 = bf16[2,128,64]{2,1,0} all-gather(%p), "
           "dimensions={0}\n"
           "%ar = (f32[16]{0}, bf16[8,8]{1,0}) all-reduce(%a, %b)\n"
           "%rs = f32[4,4]{1,0} reduce-scatter(%c), dimensions={0}\n")
    assert collective_bytes(txt) == ref(txt)
    assert collective_bytes(txt)["all-reduce"] == 2 * (16 * 4 + 64 * 2)


# ------------------------------------------------------- a combination
def test_a_combination_at_16x16_runs_inside_a_placeholder_world(tmp_path):
    """The CLI on one production combination: its artifact holds the
    reference's record keys (``trace_s`` for ``compile_s``), and the
    process group is gone afterwards."""
    dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    assert not dist.is_initialized()
    (artifact,) = tmp_path.glob("*.json")
    assert artifact.name == "whisper_tiny__decode_32k__pod16x16.json"
    record = json.loads(artifact.read_text())
    assert record["n_devices"] == 256 and record["trace_s"] > 0
    assert {"flops_per_device", "bytes_per_device", "collectives",
            "t_compute", "t_memory", "t_collective", "bottleneck",
            "useful_fraction", "memory_gb_per_device", "attn_impl",
            "remat", "kv_shard", "microbatch", "donate",
            "skipped"} <= set(record)
    assert record["flops_per_device"] > 0 and record["skipped"] is False


def test_long_500k_skips_the_audio_family():
    cost, meta = dryrun.lower_combo("whisper_tiny", "long_500k")
    assert cost is None and meta["skipped"]
    assert not dist.is_initialized()


def test_placeholder_world_refuses_to_nest():
    import logging
    quiet = logging.getLogger("torch.distributed.tensor")
    level = quiet.level
    with placeholder_world(4):
        assert quiet.level == logging.ERROR   # the fake group's warnings
        with pytest.raises(RuntimeError, match="already"):
            with placeholder_world(4):
                pass
    assert not dist.is_initialized()
    assert quiet.level == level
    with pytest.raises(RuntimeError, match="placeholder_world"):
        make_production_mesh()


def test_kernel_wrappers_route_meta_tensors_to_their_plain_versions():
    from repro_torch.kernels.flash_decode.ops import ring_decode_attention
    from repro_torch.kernels.flash_prefill.ops import flash_attention
    from repro_torch.kernels.rwkv6_chunk.ops import linear_attention
    m = dict(device="meta")
    out = ring_decode_attention(
        torch.empty(2, 4, 32, **m), torch.empty(2, 2, 16, 32, **m),
        torch.empty(2, 2, 16, 32, **m),
        torch.empty(2, dtype=torch.int32, **m),
        torch.empty(2, dtype=torch.int32, **m))
    assert out.device.type == "meta" and tuple(out.shape) == (2, 4, 32)
    out = flash_attention(torch.empty(2, 4, 8, 32, **m),
                          torch.empty(2, 2, 8, 32, **m),
                          torch.empty(2, 2, 8, 32, **m),
                          torch.empty(2, dtype=torch.int32, **m),
                          torch.empty(2, dtype=torch.int32, **m))
    assert out.device.type == "meta" and tuple(out.shape) == (2, 4, 8, 32)
    out, state = linear_attention(
        torch.empty(1, 2, 64, 16, **m), torch.empty(1, 2, 64, 16, **m),
        torch.empty(1, 2, 64, 16, **m), torch.empty(1, 2, 64, 16, **m),
        torch.empty(2, 16, **m))
    assert out.device.type == "meta" and tuple(state.shape) == (1, 2, 16,
                                                                16)


def test_roofline_twin_records_a_derived_section(tmp_path):
    """``benchmarks.torch_roofline`` over the dry-run's artifacts: a
    ``roofline`` section labelled ``"derived"``, which the schema gate
    holds to that label both ways."""
    import benchmarks.torch_check_bench as check_bench
    from benchmarks import torch_roofline
    out = tmp_path / "artifacts"
    dryrun.main(["--arch", "whisper_tiny", "--shape", "decode_32k",
                 "--out", str(out)])
    bench = tmp_path / "bench.json"
    assert torch_roofline.run(str(tmp_path / "none"), bench) is None
    assert not bench.exists()
    section = torch_roofline.run(str(out), bench)
    assert section["combos"] == 1 and section["device"] == "derived"
    assert section["rows"][0]["arch"] == "whisper_tiny"
    assert sum(section["bottlenecks"].values()) == 1
    errors = check_bench.check(bench)
    assert not [e for e in errors if "roofline" in e]
    data = json.loads(bench.read_text())
    data["roofline"]["device"] = "cpu"
    data["kernels"] = {"kernels": [], "device": "derived", "scale": {},
                       "wall_s": 0.0, "predictor": None}
    bench.write_text(json.dumps(data))
    errors = check_bench.check(bench)
    assert any("roofline is derived" in e for e in errors)
    assert any("kernels was measured, but says 'derived'" in e
               for e in errors)


def test_kv_shard_seq_splits_the_cache_that_heads_cannot():
    """llama3_2_3b's 8 KV heads do not split 16 ways, so ``"heads"`` keeps
    the whole cache on every rank of the model axis; ``"seq"`` splits its
    length there, and decode attention merges the runs across ranks."""
    costs = {kv: dryrun.lower_combo("llama3_2_3b", "decode_32k",
                                    kv_shard=kv)[0] for kv in ("heads", "seq")}
    assert costs["seq"].peak_bytes < costs["heads"].peak_bytes / 8
    # the merge: a max and two sums of (B/16, H) f32 over the model axis
    assert costs["seq"].collectives["all-reduce"] > \
        costs["heads"].collectives["all-reduce"]
