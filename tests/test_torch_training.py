"""The port's training half against the JAX reference.

Same seeded numpy inputs and bridged reference parameters go through the
JAX function and its port, with JAX at "highest" matmul precision
(``tests/conftest.py``): the ranking losses and their gradients (1e-6), one
Adam step (1e-6 relative), checkpoints in the reference's format, the LM's
loss (1e-5) and per-leaf gradients (1e-4 of each leaf's max |g|), one train
step (1e-5), the train driver, microbatching, remat and chunked attention;
then the launchers at smoke size on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import model  # noqa: F401  (the bridged llama fixture)

from repro.core.predictor import losses as jlosses
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.training import optimizer as jopt
from repro.training.train_loop import make_train_step as jax_train_step
from repro.training.train_loop import train as jax_train
from repro.training.checkpoint import _flatten
from repro_torch import bridge
from repro_torch.core.predictor import losses
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as attn
from repro_torch.models import model as tmodel
from repro_torch.training import (Adam, apply_updates, cosine_schedule,
                                  global_norm, load_checkpoint,
                                  save_checkpoint)
from repro_torch.training.train_loop import make_train_step, train

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_np(tree):
    """A port tree of tensors as ``{path: numpy}``."""
    return {k: v.numpy() for k, v in bridge.flatten(tree).items()}


def _jax_np(tree):
    return {k: np.asarray(v) for k, v in _flatten(tree).items()}


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


# ---------------------------------------------------------------- losses
def _scores(rng, n):
    """Scores with ties: pairs of equal entries and exact hinge points."""
    s = rng.standard_normal(n).astype(np.float32)
    s[1] = s[0]
    return s


LOSS_TOL = dict(atol=1e-6, rtol=1e-6)


def test_margin_ranking_loss_and_grad_match():
    rng = np.random.default_rng(0)
    s_a, s_b = _scores(rng, 16), _scores(rng, 16)
    y = np.where(rng.random(16) < 0.5, 1.0, -1.0).astype(np.float32)
    s_a[2], s_b[2], y[2] = 0.0, 0.0, 1.0          # equal scores
    s_a[3], s_b[3], y[3] = 2.0, 1.0, 1.0          # exactly on the hinge
    s_a[4], s_b[4], y[4] = 1.0, 2.0, -1.0         # on the hinge, y = -1
    ref, (jga, jgb) = jax.value_and_grad(
        jlosses.margin_ranking_loss, argnums=(0, 1))(s_a, s_b, y)
    ta, tb = _t(s_a).requires_grad_(), _t(s_b).requires_grad_()
    out = losses.margin_ranking_loss(ta, tb, _t(y))
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), **LOSS_TOL)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jga), **LOSS_TOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jgb), **LOSS_TOL)


def test_l1_pointwise_loss_and_grad_match():
    rng = np.random.default_rng(1)
    lengths = rng.integers(1, 400, 16).astype(np.float32)
    s = _scores(rng, 16)
    s[5] = lengths[5] / losses.POINTWISE_SCALE     # exactly on the kink
    ref, jg = jax.value_and_grad(jlosses.l1_pointwise_loss)(s, lengths)
    ts = _t(s).requires_grad_()
    out = losses.l1_pointwise_loss(ts, _t(lengths))
    out.backward()
    assert losses.POINTWISE_SCALE == jlosses.POINTWISE_SCALE
    np.testing.assert_allclose(out.item(), float(ref), **LOSS_TOL)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jg), **LOSS_TOL)


def test_listmle_loss_and_grad_match():
    rng = np.random.default_rng(2)
    s = rng.standard_normal((3, 8)).astype(np.float32)
    s[0, 1] = s[0, 0]                              # tied scores
    lengths = rng.integers(1, 50, (3, 8)).astype(np.float32)
    lengths[1, :4] = 7.0                           # tied lengths
    ref, jg = jax.value_and_grad(jlosses.listmle_loss)(s, lengths)
    ts = _t(s).requires_grad_()
    out = losses.listmle_loss(ts, _t(lengths))
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), **LOSS_TOL)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jg), **LOSS_TOL)


# ---------------------------------------------------------------- Adam
def _adam_tree(rng):
    return {"embed": rng.standard_normal((6, 4)).astype(np.float32),
            "layers": {"w": rng.standard_normal((2, 4, 3)).astype(np.float32),
                       "b": rng.standard_normal((2, 3)).astype(np.float32)}}


def _nested(flat_np):
    return bridge.unflatten({k: _t(v) for k, v in flat_np.items()})


@pytest.mark.parametrize("step", [1, 6], ids=["warmup", "after-warmup"])
def test_adam_step_matches_reference(step):
    """One update from a state at ``step`` (warmup 3 of 10 cosine steps) on
    gradients whose norm is clipped (clip 0.5), with weight decay:
    updates, moments and new parameters to 1e-6 relative."""
    rng = np.random.default_rng(3)
    params, grads = _adam_tree(rng), _adam_tree(rng)
    mu = _adam_tree(rng)
    nu = {k: np.abs(v) for k, v in _flatten(_adam_tree(rng)).items()}
    kw = dict(clip_norm=0.5, weight_decay=0.01)
    jadam = jopt.Adam(learning_rate=jopt.cosine_schedule(1e-2, 3, 10), **kw)
    adam = Adam(learning_rate=cosine_schedule(1e-2, 3, 10), **kw)
    jstate = jopt.AdamState(step=jnp.asarray(step - 1, jnp.int32), mu=mu,
                            nu=bridge.unflatten(nu))
    jup, jstate = jadam.update(grads, jstate, params)
    jnew = jopt.apply_updates(params, jup)
    assert float(jopt.global_norm(grads)) > 0.5      # clipping triggers

    tparams = _nested(_flatten(params))
    state = adam.init(tparams)
    for k, v in _flatten(mu).items():
        bridge.flatten(state.mu)[k].copy_(_t(v))
    for k, v in nu.items():
        bridge.flatten(state.nu)[k].copy_(_t(v))
    state = state._replace(step=step - 1)
    gtree = _nested(_flatten(grads))
    np.testing.assert_allclose(global_norm(gtree).item(),
                               float(jopt.global_norm(grads)), rtol=1e-6)
    up, state = adam.update(gtree, state, tparams)
    out = apply_updates(tparams, up)
    assert state.step == int(jstate.step) == step
    tol = dict(rtol=1e-6, atol=1e-9)
    for mine, ref in ((up, jup), (state.mu, jstate.mu), (state.nu, jstate.nu),
                      (out, jnew)):
        ref_np = _jax_np(ref)
        for k, v in _port_np(mine).items():
            np.testing.assert_allclose(v, ref_np[k], err_msg=k, **tol)
    assert out is tparams                            # updated in place


@pytest.mark.parametrize("step", [0, 2, 3, 7, 10, 12])
def test_cosine_schedule_matches_reference(step):
    ref = jopt.cosine_schedule(3e-4, 3, 10)(jnp.asarray(step, jnp.int32))
    np.testing.assert_allclose(float(cosine_schedule(3e-4, 3, 10)(step)),
                               float(ref), rtol=1e-6)


# ---------------------------------------------------------------- checkpoints
def test_bf16_tree_reloads_bitwise(tmp_path):
    tree = {"embed": torch.randn(5, 3).to(torch.bfloat16),
            "layers": {"w": torch.randn(2, 3, 3).to(torch.bfloat16),
                       "scale": torch.randn(2, 3)},
            "step": torch.arange(4, dtype=torch.int32)}
    path = str(tmp_path / "tree.npz")
    save_checkpoint(path, tree, metadata={"arch": "x"})
    like = {"embed": torch.zeros(5, 3, dtype=torch.bfloat16),
            "layers": {"w": torch.zeros(2, 3, 3, dtype=torch.bfloat16),
                       "scale": torch.zeros(2, 3)},
            "step": torch.zeros(4, dtype=torch.int32)}
    back = load_checkpoint(path, like)
    read, meta = bridge.load_npz(path, device="cpu")
    assert meta == {"arch": "x"}
    for other in (back, read):
        for k, v in bridge.flatten(tree).items():
            got = bridge.flatten(other)[k]
            assert got.dtype == v.dtype and torch.equal(got, v), k
    # the reference's layout: 2-byte void leaves, dtype named in the manifest
    with np.load(path) as data:
        assert data["embed"].dtype == np.dtype("V2")
    manifest = __import__("json").load(open(path + ".json"))["manifest"]
    assert manifest["embed"]["dtype"] == "bfloat16"
    assert manifest["layers/scale"] == {"shape": [2, 3], "dtype": "float32"}


# ---------------------------------------------------------------- the LM
def _batch(cfg, b=2, s=12, seed=4):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    tgts = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts),
          "loss_mask": jnp.asarray(mask)}
    tb = {"tokens": _t(toks).long(), "targets": _t(tgts).long(),
          "loss_mask": _t(mask)}
    return jb, tb


def test_cross_entropy_and_lm_loss_match(model):
    jcfg, jparams, cfg, params = model
    jb, tb = _batch(cfg)
    logits = np.random.default_rng(5).standard_normal(
        (2, 12, cfg.vocab_size)).astype(np.float32) * 3
    ref = jmodel.cross_entropy(jnp.asarray(logits), jb["targets"],
                               jb["loss_mask"])
    out = tmodel.cross_entropy(_t(logits), tb["targets"], tb["loss_mask"])
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)
    jloss, jmet = jmodel.lm_loss(jparams, jcfg, jb, remat="none")
    loss, met = tmodel.lm_loss(params, cfg, tb, remat="none")
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(met["ce"].item(), float(jmet["ce"]), rtol=1e-5)
    assert set(met) == set(jmet)


def test_lm_loss_grads_match_per_leaf(model):
    jcfg, jparams, cfg, params = model
    jb, tb = _batch(cfg)
    jg = _flatten(jax.grad(lambda p: jmodel.lm_loss(
        p, jcfg, jb, remat="none")[0])(jparams))
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in bridge.flatten(params).items()}
    loss, _ = tmodel.lm_loss(bridge.unflatten(leaves), cfg, tb, remat="none")
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert set(grads) == set(jg)
    for k, ref in jg.items():
        ref = np.asarray(ref)
        np.testing.assert_allclose(grads[k].numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=k)


def test_train_step_matches_reference(model):
    """One step of each framework's ``make_train_step`` (chunked attention,
    no remat, clipped Adam on a cosine schedule) from the same parameters:
    new parameters to 1e-5, loss and grad norm to 1e-5 relative."""
    jcfg, jparams, cfg, params = model
    jb, tb = _batch(cfg)
    jopt_ = jopt.Adam(learning_rate=jopt.cosine_schedule(3e-4, 5, 20),
                      clip_norm=1.0)
    jp, _, jm = jax.jit(jax_train_step(jcfg, jopt_, remat="none"))(
        jparams, jopt_.init(jparams), jb)
    opt = Adam(learning_rate=cosine_schedule(3e-4, 5, 20), clip_norm=1.0)
    mine = _clone(params)
    out, state, m = make_train_step(cfg, opt, remat="none")(
        mine, opt.init(mine), tb)
    assert out is mine and state.step == 1
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5)
    ref = _jax_np(jp)
    for k, v in _port_np(out).items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    # the caller's tensors never required grad
    assert not any(v.requires_grad for v in bridge.flatten(out).values())


def test_train_driver_matches_reference(model):
    """Three steps of each framework's ``train`` driver on the same batches
    (default Adam, chunked attention, no remat), a record every step: the
    same keys, losses and grad norms to 1e-5 relative."""
    jcfg, jparams, cfg, params = model
    batches = [_batch(cfg, seed=10 + i) for i in range(3)]
    _, jhist = jax_train(jcfg, jparams, [jb for jb, _ in batches], steps=3,
                         log_every=1, remat="none", log_fn=lambda m: None)
    _, hist = train(cfg, _clone(params), [tb for _, tb in batches], steps=3,
                    log_every=1, remat="none", log_fn=lambda m: None)
    assert [set(h) for h in hist] == [set(h) for h in jhist]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in hist],
                                   [h[key] for h in jhist], rtol=1e-5)


def _one_step(cfg, params, batch, **kw):
    opt = Adam(learning_rate=1e-3, clip_norm=1.0)
    p = _clone(params)
    _, _, m = make_train_step(cfg, opt, **kw)(p, opt.init(p), batch)
    return p, m


def test_microbatch_equals_one_batch(model):
    _jcfg, _jparams, cfg, params = model
    _, tb = _batch(cfg, b=4)
    tb["loss_mask"] = torch.ones_like(tb["loss_mask"])   # equal-weight halves
    p1, m1 = _one_step(cfg, params, tb, remat="none")
    p2, m2 = _one_step(cfg, params, tb, remat="none", microbatch=2)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    # Adam's first step is lr * g / (|g| + eps): where g is near 0 a change
    # of g in its last digits moves the update by a share of lr, so the
    # parameters agree to 1% of lr = 1e-3
    for k, v in bridge.flatten(p1).items():
        np.testing.assert_allclose(bridge.flatten(p2)[k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_remat_full_equals_none(model):
    _jcfg, _jparams, cfg, params = model
    _, tb = _batch(cfg)
    p0, m0 = _one_step(cfg, params, tb, remat="none")
    p1, m1 = _one_step(cfg, params, tb, remat="full")
    assert float(m0["loss"]) == float(m1["loss"])
    for k, v in bridge.flatten(p0).items():
        assert torch.equal(bridge.flatten(p1)[k], v), k


def test_training_forward_refuses_what_it_does_not_run(model):
    _jcfg, _jparams, cfg, params = model
    toks = torch.zeros(1, 4, dtype=torch.long)
    from repro_torch.models import transformer as tfm
    # "dots" (the reference's policy) runs: the forward is "none"'s
    dots, _, _ = tfm.forward_seq(params, cfg, toks, attn_impl="chunked",
                                 remat="dots")
    none, _, _ = tfm.forward_seq(params, cfg, toks, attn_impl="chunked")
    assert torch.equal(dots, none)
    with pytest.raises(ValueError, match="remat"):
        tfm.forward_seq(params, cfg, toks, attn_impl="chunked",
                        remat="offload")
    # a prefill into a cache takes no remat on either route
    with pytest.raises(ValueError, match="remat"):
        tfm.forward_seq(params, cfg, toks, attn_impl="chunked",
                        build_cache=True, cache_len=16, remat="full")
    # the plain route builds the cache the kernel route builds (the
    # dry-run's prefill)
    plain, cache, _ = tfm.forward_seq(params, cfg, toks, attn_impl="chunked",
                                      build_cache=True, cache_len=16)
    kern, ref, _ = tfm.forward_seq(params, cfg, toks, build_cache=True,
                                   cache_len=16)
    torch.testing.assert_close(plain, kern, atol=1e-5, rtol=1e-5)
    assert sorted(cache) == sorted(ref)
    for key in cache:
        torch.testing.assert_close(cache[key], ref[key], atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("window", [None, 40])
def test_attention_chunked_matches_naive_and_reference(window):
    """GQA over 4 chunks of 32 keys (H=4, KH=2), causal, with and without
    a window; at 2e-5 (f32, the kernels' tolerance)."""
    rng = np.random.default_rng(6)
    b, s, h, kh, d = 2, 128, 4, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    ref = jattn.attention_chunked(q, k, v, pos, pos, window=window,
                                  kv_chunk=32)
    args = (_t(q), _t(k), _t(v), _t(pos), _t(pos))
    out = attn.attention_chunked(*args, window=window, kv_chunk=32)
    naive = attn.attention_naive(*args, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), naive.numpy(), atol=2e-5,
                               rtol=2e-5)
    dispatched = attn.attention(*args, window=window, kv_chunk=32)
    assert torch.equal(dispatched, out)


# ---------------------------------------------------------------- launchers
def test_train_launcher_runs_on_cpu(capsys, tmp_path):
    path = str(tmp_path / "lm.npz")
    params, history = launch_train.main(
        ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
         "--microbatch", "2", "--ckpt", path])
    assert len(history) == 3
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in history)
    back, meta = bridge.load_npz(path, device="cpu")
    assert meta["arch"] == "llama3.2-3b"
    for k, v in bridge.flatten(params).items():
        assert torch.equal(bridge.flatten(back)[k], v), k
    assert "checkpoint:" in capsys.readouterr().out


def test_serve_launcher_trains_its_predictor(capsys):
    rep = launch_serve.main(["--device", "cpu", "--policy", "pars",
                             "--requests", "6", "--batch", "2",
                             "--max-len", "8"])
    out = capsys.readouterr().out
    assert rep.n_requests == 6
    assert "[pairwise/bert] epoch 1" in out
