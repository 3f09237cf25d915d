"""Training the hybrid, SSM and encoder-decoder families against the JAX
reference, the ``build()`` bundle, and the training example twin.

Smoke configs in f32 from bridged reference parameters, JAX at "highest"
matmul precision: ``lm_loss`` (1e-5 relative) and its per-leaf gradients
(1e-4 of each leaf's max |g|) against ``jax.grad`` of the reference's
``lm_loss`` for ``whisper_tiny``, ``hymba_1_5b`` (its SSD scan at chunk 32
on both sides) and ``rwkv6_7b``; one ``make_train_step`` step (1e-5);
``remat="dots"`` and ``"full"`` gradients equal to ``"none"``'s; the
bundle's four callables against the reference's ``build()``; every
config's ``param_count`` against the reference's leaves; the launcher and
``examples/torch_train_lm.py`` on the CPU.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import transformer as jtfm
from repro.training import optimizer as jopt
from repro.training.checkpoint import _flatten
from repro.training.train_loop import make_train_step as jax_train_step
from repro_torch import bridge, configs
from repro_torch.launch import train as launch_train
from repro_torch.models import build
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as tfm
from repro_torch.training import Adam, cosine_schedule
from repro_torch.training.train_loop import make_train_step, value_and_grad

torch.set_num_threads(1)
FAMILIES = ["whisper_tiny", "hymba_1_5b", "rwkv6_7b"]
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    arch = request.param
    jcfg = jconfigs.get_smoke_config(arch).replace(dtype="float32")
    cfg = configs.get_smoke_config(arch).replace(dtype="float32")
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_flat(_flatten(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(cfg, b=2, s=32, seed=4):
    """Same numpy batch for both frameworks; an audio batch adds frames."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
              "targets": rng.integers(0, cfg.vocab_size, (b, s)),
              "loss_mask": (rng.random((b, s)) < 0.8).astype(np.float32)}
    arrays["tokens"] = arrays["tokens"].astype(np.int32)
    arrays["targets"] = arrays["targets"].astype(np.int32)
    if cfg.is_encdec:
        arrays["frames"] = (rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.d_model)) * 0.02).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: _t(v).long() if v.dtype == np.int32 else _t(v)
          for k, v in arrays.items()}
    return jb, tb


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _grads(cfg, params, batch, remat):
    (loss, _), grads = value_and_grad(
        lambda p, b: tmodel.lm_loss(p, cfg, b, remat=remat), params, batch)
    return loss, bridge.flatten(grads)


def test_lm_loss_and_grads_match_reference(family):
    """Per-leaf gradients at 1e-4 of the leaf's max |g|. A key bias's exact
    gradient is zero (it adds one constant to all of a query's scores,
    which the softmax cancels), so both frameworks give rounding noise
    there: those leaves are held to zero instead, at 1e-6 of the same
    block's query-weight gradient."""
    jcfg, jparams, cfg, params = family
    jb, tb = _batch(cfg)
    jloss, _ = jmodel.lm_loss(jparams, jcfg, jb, remat="none")
    jg = _flatten(jax.grad(lambda p: jmodel.lm_loss(
        p, jcfg, jb, remat="none")[0])(jparams))
    loss, grads = _grads(cfg, params, tb, "none")
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(grads) == set(jg)
    for k, ref in jg.items():
        ref = np.asarray(ref)
        if k.endswith("/bk"):
            scale = np.abs(np.asarray(jg[k[:-2] + "wq"])).max()
            assert np.abs(ref).max() <= 1e-6 * scale, k
            assert grads[k].abs().max().item() <= 1e-6 * scale, k
            continue
        np.testing.assert_allclose(grads[k].numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=k)


def test_train_step_matches_reference(family):
    """One step of each framework's ``make_train_step`` (chunked attention,
    the plain scan, no remat, clipped Adam on a cosine schedule): new
    parameters to 1e-5, loss and grad norm to 1e-5 relative."""
    jcfg, jparams, cfg, params = family
    jb, tb = _batch(cfg, seed=5)
    jopt_ = jopt.Adam(learning_rate=jopt.cosine_schedule(3e-4, 5, 20),
                      clip_norm=1.0)
    jp, _, jm = jax.jit(jax_train_step(jcfg, jopt_, remat="none"))(
        jparams, jopt_.init(jparams), jb)
    opt = Adam(learning_rate=cosine_schedule(3e-4, 5, 20), clip_norm=1.0)
    mine = _clone(params)
    out, _, m = make_train_step(cfg, opt, remat="none")(
        mine, opt.init(mine), tb)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5)
    ref = {k: np.asarray(v) for k, v in _flatten(jp).items()}
    for k, v in bridge.flatten(out).items():
        np.testing.assert_allclose(v.numpy(), ref[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_gradients_equal_none(family, remat):
    """Recomputing in backward, all of a layer (``"full"``) or all but its
    weight products (``"dots"``), gives ``"none"``'s loss and gradients
    bitwise."""
    _jcfg, _jparams, cfg, params = family
    _, tb = _batch(cfg, seed=6)
    loss0, g0 = _grads(cfg, params, tb, "none")
    loss1, g1 = _grads(cfg, params, tb, remat)
    assert torch.equal(loss0, loss1)
    for k, v in g0.items():
        assert torch.equal(g1[k], v), k


def test_microbatches_carry_frames(family):
    """Two microbatches of one batch (frames sliced with the tokens) give
    the one batch's loss and gradient norm."""
    _jcfg, _jparams, cfg, params = family
    _, tb = _batch(cfg, b=4, seed=7)
    tb["loss_mask"] = torch.ones_like(tb["loss_mask"])
    metrics = []
    for mb in (1, 2):
        p = _clone(params)
        opt = Adam(learning_rate=1e-3, clip_norm=1.0)
        metrics.append(make_train_step(cfg, opt, remat="none",
                                       microbatch=mb)(p, opt.init(p), tb)[2])
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[1][key]),
                                   float(metrics[0][key]), rtol=1e-5)


def test_build_matches_the_reference_bundle(family):
    """The bundle's fields are the reference's; ``loss_fn`` (training
    route), ``prefill`` and ``decode_step`` (kernel route, the plain
    versions here) and ``init_cache`` agree with the reference's
    ``build()``."""
    jcfg, jparams, cfg, params = family
    jb_, tb_ = jmodel.build(jcfg, remat="none"), build(cfg, remat="none")
    assert list(tmodel.ModelBundle.__dataclass_fields__) == list(
        jmodel.ModelBundle.__dataclass_fields__)
    jb, tb = _batch(cfg, seed=8)
    np.testing.assert_allclose(tb_.loss_fn(params, tb)[0].item(),
                               float(jb_.loss_fn(jparams, jb)[0]), rtol=1e-5)
    extras = {"frames": tb["frames"]} if cfg.is_encdec else {}
    jextras = {"frames": jb["frames"]} if cfg.is_encdec else {}
    jl, jc = jb_.prefill(jparams, jb["tokens"][:, :16], 24, **jextras)
    logits, cache = tb_.prefill(params, tb["tokens"][:, :16], 24, **extras)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for t in range(16, 20):
        jl, jc = jb_.decode_step(jparams, jc, jb["tokens"][:, t:t + 1])
        logits, cache = tb_.decode_step(params, cache,
                                        tb["tokens"][:, t:t + 1])
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   atol=1e-4, rtol=1e-4)
    # init_cache: the reference's leaves, lanes stored heads first
    jempty = jb_.init_cache(2, 24, pos=5)
    empty = tb_.init_cache(2, 24, pos=5, device="cpu")
    assert empty["pos"].tolist() == [5, 5]
    for k, v in jempty.items():
        if k == "pos":
            continue
        shape = tuple(v.shape)
        if k in ("k", "v", "cross_k", "cross_v"):     # (L, B, W, KH, dh)
            shape = shape[:2] + (shape[3], shape[2], shape[4])
        assert tuple(empty[k].shape) == shape, k
    assert tb_.init(0, device="cpu")["embed"].shape == params["embed"].shape
    with pytest.raises(ValueError, match="no backward"):
        build(cfg, attn_impl="kernel")


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_count_counts_the_reference_leaves(arch):
    """``param_count`` from the widths alone equals the reference's
    parameter count at published widths (shapes from ``jax.eval_shape``,
    nothing allocated)."""
    jcfg = jconfigs.get_config(arch)
    shapes = jax.eval_shape(lambda: jtfm.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert tfm.param_count(configs.get_config(arch)) == ref


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_launcher_trains_each_family(arch):
    _, history = launch_train.main(["--arch", arch, "--device", "cpu",
                                    "--steps", "2", "--batch", "2",
                                    "--seq", "16", "--microbatch", "2"])
    assert len(history) == 2
    assert all(np.isfinite(h["loss"]) for h in history)


def test_train_launcher_full_refuses_what_does_not_fit(monkeypatch):
    """``--full`` refuses, before allocating, a config whose weights,
    gradients and Adam moments exceed the device (here an 80 GB card
    stands in for the host): rwkv6_7b's 7.5 B parameters at 12 bytes."""
    monkeypatch.setattr(tfm.os, "sysconf",
                        lambda name: {"SC_PAGE_SIZE": 4096,
                                      "SC_PHYS_PAGES": 80 * 2 ** 30 // 4096
                                      }[name])
    with pytest.raises(SystemExit, match="does not fit"):
        launch_train.main(["--arch", "rwkv6_7b", "--full", "--device", "cpu"])


def test_train_lm_example_runs_on_cpu(tmp_path, capsys):
    """``examples/torch_train_lm.py``, the twin of ``examples/train_lm.py``:
    the same flags and recipe on a smoke config, a checkpoint written, the
    loss falling."""
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", ROOT / "examples" / "torch_train_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = str(tmp_path / "lm.npz")
    history = example.main(["--arch", "whisper-tiny", "--steps", "61",
                            "--batch", "8", "--seq", "64", "--out", out,
                            "--device", "cpu"])
    assert [h["step"] for h in history] == [0, 20, 40, 60]
    assert history[-1]["loss"] < history[0]["loss"]
    params, meta = bridge.load_npz(out, device="cpu")
    assert meta == {"arch": "whisper-tiny", "steps": 61}
    assert "encoder" in params
    assert "checkpoint written to" in capsys.readouterr().out
