"""How ``correct`` is decided: what the window produced, against the plain
reference (``bench/reference``, through the cell's architecture's
``logits``), at the timed sizes.

Numbers compared: those the configuration file's ``limits`` name, each
against its limit there (``PERF.md`` gives the readings each was set from):

* ``logit_gap``: over a sample of the requests the window finished (drawn
  from the seed, the longest among them), the widest gap by which a served
  token's reference logit lies below the reference's best at its position.
  The reference runs each prompt, padded to its bucket as served, with the
  served tokens, and rebuilds each MoE dispatch the schedule made: the
  prompts whose first chunks shared a dispatch (padding lanes replay lane
  0), each continuation chunk alone, each decoded token alone.
* ``logit_gap_mean``: the same gaps' mean over the sampled tokens, which
  separates the program from its control where the widest gap does not.
* ``score_gap``: in units of the spread (standard deviation) of the
  reference's scores over the window's requests, the larger of the widest
  difference between a request's score and the reference's, and half the
  widest inversion of the admission order: at each admission, how far the
  reference score of an admitted request lies above that of a request left
  waiting. Admission by the scores is right to within twice their error.
* ``prefix_hits``: cached prefixes installed; the traffic shares no
  16-token block, so any hit is a fault (limit 0).

The control puts the reference in the program's place at the next
precision down (``bench/reference/precision.py``): fp8 for a bf16 model,
TF32 for an f32 one and for the f32 predictor, read on the same prompts
and tokens.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from bench.reference import predictor as ref_predictor
from bench.reference.precision import F32, FP8, TF32
from bench.reference.tokenizer import encode


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def sample(finished: List, seed: int, tokens: int, most: int,
           least: int = 1) -> List:
    """The longest finished request, then others drawn from ``seed`` until
    ``tokens`` served tokens and ``least`` requests, or ``most``
    requests."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (r.true_length, -r.req_id))
    rest = [r for r in finished if r is not longest]
    rng = np.random.default_rng([seed, 0xc4ec])
    order = rng.permutation(len(rest))
    out, n = [longest], longest.true_length
    for i in order:
        if (n >= tokens and len(out) >= least) or len(out) >= most:
            break
        out.append(rest[i])
        n += rest[i].true_length
    return out


class Inputs:
    """How the engine saw each prompt: its ids, bucket and chunks."""

    def __init__(self, model: dict, engine: dict, window):
        self.model, self.engine, self.window = model, engine, window
        self.by_id = {r.req_id: r for r in window.requests}
        self.vocab = min(model["vocab_size"], 2048)

    def ids(self, req) -> List[int]:
        return [t % self.model["vocab_size"] for t in
                encode(req.prompt, self.vocab, self.engine["prompt_len"])]

    def bucket(self, n: int) -> int:
        p = self.engine["prompt_len"]
        return min(p, _next_pow2(max(n, min(8, p))))

    def chunks(self, req_id: int):
        """``[(call index, start, end)]`` of a request's prompt chunks."""
        return [(i, s, e) for i, call in enumerate(self.window.prefill_calls)
                for rid, s, e in call if rid == req_id]

    def case(self, req, device):
        """The reference's inputs for one served request."""
        ids = self.ids(req)
        bucket = self.bucket(len(ids))
        served = list(req.generated_tokens)
        if len(served) != req.true_length:
            raise AssertionError(f"request {req.req_id} served "
                                 f"{len(served)} of {req.true_length} tokens")
        seq = ids + [0] * (bucket - len(ids)) + served[:-1]
        chunks = self.chunks(req.req_id)
        covered = 0
        for _i, s, e in chunks:
            if s != covered:
                raise AssertionError(f"request {req.req_id}: chunk at {s} "
                                     f"after {covered} prompt tokens")
            covered = e
        if covered != bucket:
            raise AssertionError(f"request {req.req_id}: {covered} of "
                                 f"{bucket} prompt tokens prefilled")
        positions = list(range(bucket - 1, bucket - 1 + len(served)))
        t = lambda x: torch.as_tensor(x, dtype=torch.long,    # noqa: E731
                                      device=device)
        if not self.model.get("moe"):
            return t([seq]), 0, t([]), [], positions, served
        call, _s, s1 = chunks[0]
        members = [rid for rid, s, e in self.window.prefill_calls[call]
                   if s == 0 and e == s1]
        rows = []
        for rid in members:
            m_ids = self.ids(self.by_id[rid])[:s1]
            rows.append(m_ids + [0] * (s1 - len(m_ids)))
        rows += [rows[0]] * (_next_pow2(len(rows)) - len(rows))
        segments = [(s - s1, e - s1, "chunk") for _i, s, e in chunks[1:]]
        if len(seq) > bucket:
            segments.append((bucket - s1, len(seq) - s1, "token"))
        return (t(rows), members.index(req.req_id), t(seq[s1:]), segments,
                positions, served)


LOWER = {"bfloat16": FP8, "float16": FP8, "float32": TF32}


def logit_gaps(arch, params, model: dict, inputs: Inputs, reqs, device,
               control: bool) -> Dict[str, Optional[float]]:
    """Widest gap of the served tokens, and of the control's first
    choices, below the reference's best (``arch.logits``)."""
    gaps, gaps_c, margins = [], [], []
    lower = LOWER[model["dtype"]]
    for req in reqs:
        group, row, own, segs, positions, served = inputs.case(req, device)
        probe = {}
        ref = arch.logits(params, model, group, row, own, segs, positions,
                          F32, probe)
        if "margin" in probe:
            margins.append(probe["margin"].cpu())
        best = ref.max(-1).values
        idx = torch.arange(len(served), device=device)
        picked = ref[idx, torch.as_tensor(served, device=device)]
        gaps.append((best - picked).cpu())
        if control:
            low = arch.logits(params, model, group, row, own, segs,
                              positions, lower)
            gaps_c.append((best - ref[idx, low.argmax(-1)]).cpu())
        del ref
    out = {"requests": len(reqs), "tokens": sum(len(g) for g in gaps)}
    for end, g in (("", gaps), ("_control", gaps_c)):
        if not g:
            continue
        g = torch.cat(g).double().numpy()
        out["logit_gap" + end] = float(g.max())
        out["logit_gap_mean" + end] = float(g.mean())
        # how the gaps are spread, for PERF.md
        out["logit_gap_p99" + end] = float(np.percentile(g, 99))
        out["logit_gap_share" + end] = float((g > 0).mean())
    if margins:     # the router's nearest tie where the widest gap fell
        m = torch.cat(margins).double().numpy()
        g = torch.cat(gaps).double().numpy()
        out["router_margin_at_widest_gap"] = float(m[g.argmax()])
        out["router_margin_median"] = float(np.median(m))
    return out


def score_gaps(pred_params, pcfg: dict, window, reqs, device,
               control: bool) -> Dict[str, Optional[float]]:
    """Score and admission-order gap, in units of the reference scores'
    spread, and the same for the control's scores."""
    reqs = [r for r in reqs if r.scored]
    if len(reqs) < 2:
        return {}
    prompts = [r.prompt for r in reqs]
    ref = ref_predictor.score(pred_params, pcfg, prompts, device, F32)
    ref = ref.double().numpy()
    prog = np.asarray([r.score for r in reqs], np.float64)
    scale = float(ref.std()) or 1.0
    at = {r.req_id: i for i, r in enumerate(reqs)}
    out = {"score_gap": max(np.abs(prog - ref).max(),
                            _inversion(window, at, ref) / 2) / scale}
    if control:
        low = ref_predictor.score(pred_params, pcfg, prompts, device, TF32)
        low = low.double().numpy()
        out["score_gap_control"] = max(
            np.abs(low - ref).max(),
            _inversion(window, at, ref, order=low) / 2) / scale
    return out


def _inversion(window, at: dict, ref: np.ndarray,
               order: Optional[np.ndarray] = None) -> float:
    """Widest admission inversion by reference score. With ``order``, the
    admissions are decided again by those scores among the same
    candidates (the control in the program's place)."""
    worst = 0.0
    for admitted, left in window.admissions:
        a = [at[i] for i in admitted if i in at]
        w = [at[i] for i in left if i in at]
        if not a or not w:
            continue
        if order is not None:
            cand = sorted(a + w, key=lambda j: (order[j], j))
            a, w = cand[:len(a)], cand[len(a):]
        worst = max(worst, float(ref[a].max() - ref[w].min()))
    return worst
