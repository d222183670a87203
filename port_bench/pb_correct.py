"""How ``correct`` is decided: what the window's served path produced,
judged by the plain reference.

The numbers a cell's file names under ``limits``, each beside its limit
(the others print as readings):

- ``max_logit_gap``: over a sample of the requests the window finished
  (drawn from the seed, the longest one always in it), the reference
  runs once over each prompt with its served tokens, every position at
  the profile the served trace names; the number is the widest gap by
  which a served token's logit lies below the reference's best at its
  position. Greedy decoding serves the program's best, so a sound run
  reads rounding only. The sample is drawn from the requests served
  wholly at profiles whose activation grid has at least the cell's
  ``compare_min_act_bits``: on a 16-level grid (A4) bf16's rounding of
  the grid's input moves whole steps, and a reference computed at bf16
  itself departs from the f32 one as far as the fp8 control does, so
  such requests separate nothing (``PERF.md``). Beside it, the mean gap
  (``mean_logit_gap``) and the share of served tokens off the
  reference's best (``off_best_share``).
- ``profile_violations``: served tokens whose profile the manager's
  policy could not have chosen, worked out again from the configuration:
  in the saver regime an accuracy-critical request is served at the
  cheapest profile that meets the accuracy target, and any other at that
  one or at the cheapest that meets the floor.

The MoE cell compares the mean gap instead of the widest: a served token
there lies below the f32 reference's best by as much as the fp8 control's
widest gap, and so does the token a bf16 reference puts first (the top-4
of 60 experts flips under bf16 rounding; ``PERF.md``), while the mean
keeps the program apart from the control. The largest of the sampled
requests' own means (``max_request_mean_gap``) prints beside it as a
reading: the control's read less than three times the program's on the
card, too close for a limit (``PERF.md``).

The control (``check(..., control=True)``, read by ``run.py
--calibrate`` and never in a benchmark run) is the same reference at fp8
put in the program's place: at each position of the same sequences the
token fp8 puts first stands for the served token, and the same limits
decide its own ``correct``, which has to come out false."""
from __future__ import annotations

import numpy as np
import torch

from pb_reference import Reference, Served, gap_stats, profile_bits

__all__ = ["policy_profiles", "profile_violations", "comparable", "sample",
           "served", "logit_gaps", "check"]


def _activity(a: int, w: int) -> float:
    """The launcher's energy model's activity factor of ``Aa-Ww``."""
    mac = min(a, 16) * min(w, 16) / 256.0
    return 0.6 * mac + 0.4 * min(w, 16) / 16.0


def policy_profiles(mg: dict) -> tuple[str, str]:
    """``(target, saver)``: the cheapest profile whose accuracy meets the
    target, and the cheapest that meets the floor (ties to the first)."""
    acc = {int(k): v for k, v in mg["accuracy_by_w_bits"].items()}

    def accuracy(name):
        a, w = profile_bits(name)
        return acc.get(w, 0.97) - (mg["mixed_accuracy_drop"]
                                   if name == "Mixed" else 0.0)

    def cheapest(floor):
        ok = [n for n in mg["profiles"] if accuracy(n) >= floor]
        return min(ok, key=lambda n: _activity(*profile_bits(n)))

    return cheapest(mg["accuracy_target"]), cheapest(mg["accuracy_floor"])


def profile_violations(records, mg: dict) -> int:
    target, saver = policy_profiles(mg)
    bad = 0
    for r in records:
        allowed = {target} if r.req.critical else {target, saver}
        bad += sum(p not in allowed for p in r.trace)
    return bad


def sample(records, n: int, seed: int) -> list:
    """``n`` of ``records`` drawn from ``seed``, the longest (prompt and
    served tokens) always among them."""
    if not records:
        return []
    recs = sorted(records, key=lambda r: r.rid)
    longest = max(recs, key=lambda r: (len(r.req.prompt) + len(r.tokens),
                                       -r.rid))
    rest = [r for r in recs if r is not longest]
    rng = np.random.default_rng((int(seed) ^ 0x5EED) % 2 ** 63)
    k = min(len(rest), max(0, n - 1))
    pick = sorted(rng.choice(len(rest), size=k, replace=False)) if k else []
    return [longest] + [rest[i] for i in pick]


def served(recs, records, moe: bool, quantum: int) -> list:
    """The reference's view of each of ``recs``: the prompts of its
    admission wave (the requests whose first token came in the same round,
    in submission order, padded with empty rows to a power of two, as the
    scheduler admits them; only the MoE's dispatch couples them, so a
    dense model's request stands alone), its served tokens but the last,
    the prompt at the wave's profile and served token ``i``'s position at
    the profile of the step that produced token ``i + 1``. For an MoE
    stack, also every other request ``records`` completed, not wanted but
    there for the decode steps it shared, and each position's step: a
    request admitted in round ``R`` decodes from the first of that round's
    ``quantum`` steps on, one position a step."""
    waves: dict = {}
    for r in sorted(records, key=lambda x: x.rid):
        if r.round_first is not None:
            waves.setdefault(r.round_first, []).append(r)
    if moe:
        want = {id(r) for r in recs}
        recs = list(recs) + sorted(
            (r for r in records if r.tokens and id(r) not in want),
            key=lambda x: x.rid)
    out = []
    for r in recs:
        cont = np.asarray(r.tokens[:-1], np.int64)
        steps = None
        if moe:
            rows = waves[r.round_first]
            wave = [x.req.prompt for x in rows]
            wave += [np.zeros(0, np.int32)] * (
                (1 << (len(wave) - 1).bit_length()) - len(wave))
            row = rows.index(r)
            steps = quantum * r.round_first + np.arange(len(cont))
        else:
            wave, row = [r.req.prompt], 0
        out.append(Served(wave, row, cont, profile_bits(r.trace[0]),
                          [profile_bits(p) for p in r.trace[1:]], steps,
                          not moe or id(r) in want))
    return out


def logit_gaps(model: dict, params: dict, recs, records, quantum: int,
               control: bool) -> tuple[dict, dict | None]:
    """The served tokens' gaps (:func:`_numbers`), and with ``control``
    the same of the tokens the fp8 reference puts first at each position
    of the same sequences (else ``None``)."""
    seqs = served(recs, records, model.get("moe") is not None, quantum)
    ref = Reference(model, params, "f32").logits(seqs)
    dev = ref[0].device
    got = _numbers([gap_stats(lg, torch.as_tensor(r.tokens, device=dev))
                    for lg, r in zip(ref, recs)])
    if not control:
        return got, None
    low = Reference(model, params, "fp8").logits(seqs)
    return got, _numbers([gap_stats(lg, lo.argmax(dim=-1))
                          for lg, lo in zip(ref, low)])


def _numbers(per_request: list) -> dict:
    """What a cell may compare of the per-token gaps of each request: the
    widest, the mean over every token, the largest of the requests' own
    means, and the share of tokens off the reference's best."""
    gaps = torch.cat(per_request)
    return {"max_logit_gap": float(gaps.max()),
            "mean_logit_gap": float(gaps.mean()),
            "max_request_mean_gap": max(float(g.mean())
                                        for g in per_request),
            "off_best_share": float((gaps > 0).float().mean()),
            "served_tokens": int(gaps.numel())}


def comparable(records, min_act_bits: int) -> list:
    """The records served wholly at activation grids of at least
    ``min_act_bits``."""
    return [r for r in records
            if all(profile_bits(p)[0] >= min_act_bits for p in r.trace)]


def _verdict(got: dict, limits: dict, judged: bool) -> dict:
    """The numbers ``limits`` names, each beside its limit, and whether
    every one of them is there and within it."""
    nums = {k: (got[k], lim) for k, lim in limits.items() if k in got}
    return {"numbers": nums,
            "correct": judged and len(nums) == len(limits)
            and all(v <= lim for v, lim in nums.values())}


def check(cell, params: dict, done_in_window, records, seed: int,
          control: bool = False) -> dict:
    """Every compared number with its limit, the verdict, and the readings
    beside them: ``{"numbers": {name: (value, limit)}, "correct": bool,
    "info": {...}}``; with ``control``, also the fp8 control's own
    ``{"numbers", "correct"}`` under ``"control"``."""
    conf, c = cell.config, cell.cell
    limits = c["limits"]
    moe = conf["model"].get("moe")
    if moe is not None and moe["groups"] % int(c["rows"]):
        raise ValueError("the MoE's reference follows decode steps whose "
                         "dispatch groups hold one row each: the rows must "
                         "divide the groups")
    pool = comparable(done_in_window, int(c["compare_min_act_bits"]))
    recs = sample(pool, int(c["sample_requests"]), seed)
    info = {"finished": len(done_in_window), "comparable": len(pool),
            "sampled_requests": len(recs)}
    got, low = {}, {}
    if recs:
        got, low = logit_gaps(conf["model"], params, recs, records,
                              int(conf["serving"]["quantum"]), control)
    done = [r for r in records if r.status == "completed"]
    # the control stands in for the program's tokens, not its profiles
    got["profile_violations"] = profile_violations(done, conf["manager"])
    out = _verdict(got, limits, bool(recs))
    # the numbers the cell compares are those its limits name; the rest
    # are readings beside them
    info.update({k: v for k, v in got.items() if k not in limits})
    out["info"] = info
    if control:
        low = dict(low or {}, profile_violations=got["profile_violations"])
        out["control"] = _verdict(low, limits, bool(recs))
        info.update({f"control_{k}": v for k, v in low.items()
                     if k not in limits})
    return out
