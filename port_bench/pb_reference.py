"""The plain reference: the served model's forward pass, in plain
PyTorch, written from the configuration file's fields alone. It imports
nothing of the program and takes only the master weights the benchmark
made.

Semantics (the configuration's): a decoder of pre-norm layers, RMS norm
(eps 1e-6, f32), grouped-query attention with half-split RoPE, an
optional qkv bias and causal softmax at ``hd ** -0.5``, then a SiLU-gated
MLP, or the MoE block: a softmax router, the top-k experts by a stable
descending sort with their gates renormalised, a grouped capacity
dispatch (``G`` groups of consecutive tokens, each expert ``ceil(tg·k/E ·
capacity_factor)`` slots per group, ranks token-major and k-minor, pad
tokens taking none, assignments past capacity dropped), the routed
products over the dispatch buffer, and the shared experts added; then a
final RMS norm and the head (the embedding table, transposed, when tied).

The paper's ``Ax-Wy`` profiles act at every linear: the activation is
fake-quantized per token and the weight per tensor (per layer for a
stacked leaf), each onto a signed grid of ``2^(b-1)`` steps either side
with a power-of-two scale ``2^ceil(log2(amax / 2^(b-1)))``, rounding half
away from zero and clamping to ``[-2^(b-1), 2^(b-1) - 1]``; bits of 17 or
more pass through. The embedding gathers rows of the table fake-quantized
at the embed site's weight bits. The MoE's routed stacks and its two
dispatch buffers are fake-quantized per tensor.

A served request is computed as it was served. Its prompt is prefilled
with the rows of its admission wave, left-padded to the wave's bucket
(only the MoE couples the rows of a wave: its groups and capacity run
over the wave's tokens); each later position, one decode step each, sees
the prompt's keys and values and its own, and its MoE dispatch holds that
token alone (a decode step's groups hold one row each, so capacity drops
nothing) while the dispatch buffers' two scales span every row of that
step: the MoE's reference runs every request the step held, not only the
ones judged. Each position runs at its own profile: the prompt at its
wave's, each decoded token's position at that of the step that consumed
it.

``precision`` selects the arithmetic of every stored intermediate:
``f32`` (the reference: nothing rounded) or ``fp8`` (e4m3, saturating
at 448: the control a step below the configuration's bf16).
Products accumulate in f32 throughout, with TF32 off.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["profile_bits", "fq_tensor", "fq_token", "Served", "Reference",
           "gap_stats"]

_E4M3_MAX = 448.0
_BITS = 1000          # a continuation position's bits as one id: a·1000 + w
_STEPS = 128          # decode steps per block of the MoE's joint dispatch


def profile_bits(name: str) -> tuple[int, int]:
    """``(a_bits, w_bits)`` of a paper profile name; ``Mixed`` with no
    inner layers is A8-W8 at every site."""
    if name == "Mixed":
        return 8, 8
    m = re.fullmatch(r"A(\d+)-W(\d+)", name)
    if m is None:
        raise ValueError(f"unknown profile {name!r}")
    return int(m.group(1)), int(m.group(2))


def _rounder(precision: str):
    if precision == "f32":
        return lambda x: x
    if precision == "fp8":
        return lambda x: x.clamp(-_E4M3_MAX, _E4M3_MAX).to(
            torch.float8_e4m3fn).float()
    raise ValueError(f"unknown precision {precision!r}")


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _pow2_scale(amax: torch.Tensor, bits: int) -> torch.Tensor:
    s = amax.clamp_min(1e-9) / 2.0 ** (bits - 1)
    return torch.exp2(torch.ceil(torch.log2(s)).double()).float()


def _grid(x: torch.Tensor, s: torch.Tensor, bits: int) -> torch.Tensor:
    h = 2.0 ** (bits - 1)
    return torch.clamp(_round_half_away(x / s), -h, h - 1) * s


def fq_tensor(w: torch.Tensor, bits: int, lead: int = 0,
              share: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-tensor fake-quant: one scale over all of ``w``, or one per
    slice of its first axis (``lead=1``); with ``share`` (an id per
    slice), one per id, over the slices that carry it."""
    wf = w.float()
    if bits >= 17:
        return wf
    amax = (wf.abs().amax() if lead == 0 else
            wf.abs().amax(dim=tuple(range(lead, wf.ndim)), keepdim=True))
    if share is not None:
        _, inv = torch.unique(share, return_inverse=True)
        flat = amax.reshape(-1)
        top = torch.zeros(int(inv.max()) + 1, device=wf.device).scatter_reduce(
            0, inv, flat, "amax")
        amax = top[inv].view(amax.shape)
    return _grid(wf, _pow2_scale(amax, bits), bits)


def fq_token(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-token fake-quant (one scale per row of the last axis)."""
    if bits >= 17:
        return x
    return _grid(x, _pow2_scale(x.abs().amax(dim=-1, keepdim=True), bits),
                 bits)


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split RoPE; ``x [..., S, H, D]``, ``pos [..., S]``."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = pos.float()[..., None] * inv                    # [..., S, D/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


@dataclasses.dataclass
class Served:
    """One served request as the reference takes it: the prompts of its
    admission wave in row order (``row`` is its own), its served tokens
    but the last, each position's ``(a, w)`` bits, and for an MoE stack
    the decode step that consumed each continuation position (``steps``,
    ids shared by the rows of one step; ``None``: each position a step of
    its own). ``want``: whether its logits are asked for, or it is there
    only for the rows it shared its decode steps with."""

    wave: list                     # np int arrays, the wave's prompts
    row: int
    cont: np.ndarray               # served tokens[:-1]
    prompt_bits: tuple             # the wave's (a, w)
    cont_bits: list                # per continuation position
    steps: Optional[np.ndarray] = None
    want: bool = True

    @property
    def prompt(self) -> np.ndarray:
        return self.wave[self.row]


class _Wave:
    """A wave's prefill state: ``x [a, S, d]`` left-padded to bucket ``S``
    (``S`` the prompt itself for a wave of one)."""

    def __init__(self, prompts: list, bits: tuple, pad_to: Optional[int],
                 dev):
        S = pad_to or max(len(p) for p in prompts)
        a = len(prompts)
        self.bits = bits
        self.tokens = torch.zeros((a, S), dtype=torch.long, device=dev)
        self.plen = torch.tensor([len(p) for p in prompts], device=dev)
        for j, p in enumerate(prompts):
            if len(p):
                self.tokens[j, S - len(p):] = torch.as_tensor(
                    p, dtype=torch.long, device=dev)
        col = torch.arange(S, device=dev)
        self.pos = col[None] - (S - self.plen)[:, None]      # [a, S]
        self.valid = self.pos >= 0
        self.kv: dict = {}                                    # row -> (k, v)
        self.x = None


class _Cont:
    """A request's continuation: positions ``plen ..`` one token each."""

    def __init__(self, s: Served, wave: _Wave, dev):
        self.s, self.wave = s, wave
        self.tokens = torch.as_tensor(s.cont, dtype=torch.long, device=dev)
        plen = len(s.prompt)
        self.pos = plen + torch.arange(len(s.cont), device=dev)
        groups: dict = {}
        for i, b in enumerate(s.cont_bits):
            groups.setdefault(tuple(b), []).append(i)
        self.groups = {k: torch.tensor(v, dtype=torch.long, device=dev)
                       for k, v in groups.items()}
        self.bit_col = torch.tensor([_BITS * a + w for a, w in s.cont_bits],
                                    dtype=torch.long, device=dev)
        self.steps = (torch.as_tensor(s.steps, dtype=torch.long, device=dev)
                      if s.steps is not None else None)
        self.x = None


class Reference:
    """The model of configuration fields ``model`` over weight tree
    ``params`` (f32 masters, stacked ``[L, ...]``)."""

    def __init__(self, model: dict, params: dict, precision: str = "f32"):
        self.m = model
        self.p = params
        self.rnd = _rounder(precision)
        self.hd = model.get("head_dim") or model["d_model"] // model["n_heads"]
        self.moe = model.get("moe")

    # ------------------------------------------------------------ pieces
    def _lin(self, x: torch.Tensor, groups: dict, imgs: dict, bias=None):
        """``x [T, din]``: each position group at its ``(a, w)`` through
        the site whose weight images by weight bits are ``imgs``."""
        rnd = self.rnd
        y = None
        for (a, w), idx in groups.items():
            part = rnd(rnd(fq_token(x[idx], a)) @ imgs[w])
            if y is None:
                y = torch.empty((x.shape[0], part.shape[1]),
                                dtype=torch.float32, device=x.device)
            y[idx] = part
        if bias is not None:
            y = rnd(y + bias.float())
        return y

    def _norm(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        var = (x * x).mean(dim=-1, keepdim=True)
        return self.rnd(x * torch.rsqrt(var + 1e-6) * g.float())

    def _images(self, w: torch.Tensor, wbits) -> dict:
        return {b: self.rnd(fq_tensor(w, b)) for b in wbits}

    def _attend(self, q, k, v, qpos, kpos, kvalid):
        """``q [Sq, H, D]`` against ``k/v [Sk, Hkv, D]``: key ``j`` is
        seen from query ``i`` when valid and ``kpos[j] <= qpos[i]``;
        queries in blocks of 512 → ``[Sq, H·D]``."""
        Sq, H, D = q.shape
        hkv = k.shape[1]
        qh = self.rnd(q * D ** -0.5).view(Sq, hkv, H // hkv, D)
        qh = qh.permute(1, 2, 0, 3)                       # [Hkv, Hg, Sq, D]
        kh, vh = k.permute(1, 0, 2), v.permute(1, 0, 2)   # [Hkv, Sk, D]
        out = torch.empty((hkv, H // hkv, Sq, D), dtype=torch.float32,
                          device=q.device)
        for q0 in range(0, Sq, 512):
            q1 = min(Sq, q0 + 512)
            sc = torch.einsum("kgsd,kud->kgsu", qh[:, :, q0:q1], kh)
            see = (kpos[None, :] <= qpos[q0:q1, None]) & kvalid[None, :]
            sc = sc.masked_fill(~see, float("-inf"))
            # a pad query sees no key: its row is zero, not NaN
            pr = torch.nan_to_num(torch.softmax(sc, dim=-1), nan=0.0)
            out[:, :, q0:q1] = torch.einsum("kgsu,kud->kgsd", pr, vh)
        return self.rnd(out.permute(2, 0, 1, 3).reshape(Sq, H * D))

    def _mlp(self, h, groups, lw):
        y = self._lin(h, groups, lw["w_in"])
        f = y.shape[1] // 2
        y = self.rnd(self.rnd(F.silu(y[:, :f])) * y[:, f:])
        return self._lin(y, groups, lw["w_out"])

    def _moe(self, h, bits, lw, valid, G: int, share=None):
        """The MoE block over ``h [T, d]`` (``valid [T]``), all at
        ``bits``, in ``G`` groups of consecutive tokens; its two buffers
        fake-quantized with one scale over all of them (a wave), or, with
        ``share`` (a decode step's id per group, each group one token),
        with one scale over the groups of each step."""
        moe, rnd = self.moe, self.rnd
        T, d = h.shape
        E, k = moe["n_routed"], moe["top_k"]
        a_bits, w_bits = bits
        tg = T // G
        cap = math.ceil(tg * k / E * moe["capacity_factor"])
        lead = 0 if share is None else 1
        every = {bits: torch.arange(T, device=h.device)}
        probs = torch.softmax(self._lin(h, every, lw["router"]), dim=-1)
        vals, idx = torch.sort(probs.view(G, tg, E), dim=-1,
                               descending=True, stable=True)
        vals, idx = vals[..., :k], idx[..., :k]
        gates = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
        flat_e = idx.reshape(G, tg * k)
        tv = valid.view(G, tg).repeat_interleave(k, dim=1)
        onehot = F.one_hot(flat_e, E).to(torch.int64) * tv[..., None]
        rank = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(-1)
        keep = (rank < cap) & tv
        slot = torch.where(keep, flat_e * cap + rank,
                           torch.full_like(flat_e, E * cap))
        buf = torch.zeros((G, E * cap + 1, d), device=h.device)
        buf.scatter_(1, slot[..., None].expand(-1, -1, d),
                     h.view(G, tg, d).repeat_interleave(k, dim=1))
        buf = buf[:, :-1].reshape(G, E, cap, d)
        x1 = rnd(fq_tensor(buf, a_bits, lead, share))
        y1 = rnd(torch.einsum("gecd,edf->gecf", x1, lw["w_in_r"][w_bits]))
        f = y1.shape[-1] // 2
        y1 = rnd(F.silu(y1[..., :f]) * y1[..., f:])
        y1 = rnd(fq_tensor(y1, a_bits, lead, share))
        out = rnd(torch.einsum("gecf,efd->gecd", y1,
                               lw["w_out_r"][w_bits]))
        flat = torch.cat([out.reshape(G, E * cap, d),
                          torch.zeros((G, 1, d), device=h.device)], dim=1)
        y_rep = flat.gather(1, slot[..., None].expand(-1, -1, d))
        y = rnd((y_rep.view(G, tg, k, d) * gates[..., None]).sum(2)
                .reshape(T, d))
        if "shared_in" in lw:
            s = self._lin(h, every, lw["shared_in"])
            fs = s.shape[1] // 2
            s = rnd(rnd(F.silu(s[:, :fs])) * s[:, fs:])
            y = rnd(y + self._lin(s, every, lw["shared_out"]))
        return y

    def _layer_weights(self, l: int, wbits) -> dict:
        """Layer ``l``'s weight images at every weight width in
        ``wbits``."""
        lp = self.p["layers"]
        lw = {"qkv": self._images(lp["qkv"]["w"][l], wbits),
              "qkv_b": lp["qkv"]["b"][l] if "b" in lp["qkv"] else None,
              "attn_out": self._images(lp["attn_out"]["w"][l], wbits),
              "g_attn": lp["norm_attn"]["g"][l],
              "g_mlp": lp["norm_mlp"]["g"][l]}
        if self.moe is None:
            lw["w_in"] = self._images(lp["mlp"]["w_in"]["w"][l], wbits)
            lw["w_out"] = self._images(lp["mlp"]["w_out"]["w"][l], wbits)
            return lw
        mp = lp["moe"]
        lw["router"] = self._images(mp["router"]["w"][l], wbits)
        lw["w_in_r"] = self._images(mp["w_in"][l], wbits)
        lw["w_out_r"] = self._images(mp["w_out"][l], wbits)
        for name in ("shared_in", "shared_out"):
            if name in mp:
                lw[name] = self._images(mp[name]["w"][l], wbits)
        return lw

    # ------------------------------------------------------------- stages
    def _attn_block(self, x, groups, lw, pos):
        """``x [T, d]`` → ``(q, k, v)`` at positions ``pos [T]``."""
        m, rnd, hd = self.m, self.rnd, self.hd
        H, Hkv = m["n_heads"], m["n_kv"]
        T = x.shape[0]
        y = self._lin(self._norm(x, lw["g_attn"]), groups, lw["qkv"],
                      lw["qkv_b"])
        q = rnd(_rope(y[:, :H * hd].reshape(T, H, hd), pos, m["rope_theta"]))
        k = rnd(_rope(y[:, H * hd:(H + Hkv) * hd].reshape(T, Hkv, hd), pos,
                      m["rope_theta"]))
        v = y[:, (H + Hkv) * hd:].reshape(T, Hkv, hd)
        return q, k, v

    def _wave_layer(self, w: _Wave, lw: dict, keep_rows) -> None:
        a, S = w.tokens.shape
        d = self.m["d_model"]
        x = w.x.reshape(a * S, d)
        grp = {w.bits: torch.arange(a * S, device=x.device)}
        q, k, v = self._attn_block(x, grp, lw, w.pos.reshape(-1))
        q, k, v = (t.view(a, S, *t.shape[1:]) for t in (q, k, v))
        att = torch.empty((a, S, q.shape[2] * self.hd), device=x.device)
        for j in range(a):
            att[j] = self._attend(q[j], k[j], v[j], w.pos[j], w.pos[j],
                                  w.valid[j])
            if j in keep_rows:
                vj = w.valid[j]
                w.kv[j] = (k[j][vj], v[j][vj])
        x = self.rnd(x + self._lin(att.view(a * S, -1), grp, lw["attn_out"]))
        h = self._norm(x, lw["g_mlp"])
        if self.moe is None:
            y = self._mlp(h, grp, lw)
        else:
            y = self._moe(h, w.bits, lw, w.valid.reshape(-1),
                          self.moe["groups"])
        w.x = self.rnd(x + y).view(a, S, d)

    def _cont_attn(self, c: _Cont, lw: dict) -> None:
        """A continuation's attention at one layer, over its prompt's keys
        and its own."""
        x = c.x
        pk, pv = c.wave.kv[c.s.row]
        plen = pk.shape[0]
        q, k, v = self._attn_block(x, c.groups, lw, c.pos)
        kpos = torch.cat([torch.arange(plen, device=x.device), c.pos])
        att = self._attend(q, torch.cat([pk, k]), torch.cat([pv, v]), c.pos,
                           kpos, torch.ones_like(kpos, dtype=torch.bool))
        c.x = self.rnd(x + self._lin(att, c.groups, lw["attn_out"]))

    def _cont_ffn(self, conts: list, lw: dict) -> None:
        """The continuations' MLP, or their MoE: each decoded token alone
        in its dispatch group (a decode step's groups hold one row each,
        so capacity drops nothing), the two buffers' scales shared by the
        tokens of one decode step, as the program's step holds every live
        row in one buffer (:attr:`Served.steps`), in blocks of
        :data:`_STEPS` steps."""
        if self.moe is None:
            for c in conts:
                h = self._norm(c.x, lw["g_mlp"])
                c.x = self.rnd(c.x + self._mlp(h, c.groups, lw))
            return
        x = torch.cat([c.x for c in conts])
        h = self._norm(x, lw["g_mlp"])
        step = torch.cat([c.steps for c in conts])
        bits = torch.cat([c.bit_col for c in conts])
        y = torch.empty_like(x)
        ids = torch.unique(step)
        for s0 in range(0, len(ids), _STEPS):
            blk = torch.isin(step, ids[s0:s0 + _STEPS])
            for b in torch.unique(bits[blk]).tolist():
                idx = torch.nonzero(blk & (bits == b))[:, 0]
                n = len(idx)
                y[idx] = self._moe(h[idx], divmod(b, _BITS), lw,
                                   torch.ones(n, dtype=torch.bool,
                                              device=x.device),
                                   n, share=step[idx])
        at = 0
        for c in conts:
            n = c.x.shape[0]
            c.x = self.rnd(c.x + y[at:at + n])
            at += n

    @torch.no_grad()
    def logits(self, served: list) -> list[torch.Tensor]:
        """The logits ``[n, vocab]`` (f32) each wanted served request's
        tokens were drawn from: its prompt's last position, then each
        continuation position."""
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._logits(served)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32

    def _logits(self, served: list) -> list[torch.Tensor]:
        m, p = self.m, self.p
        dev = p["norm_f"]["g"].device
        waves: dict = {}
        conts = []
        for s in served:
            key = tuple(np.asarray(x, np.int32).tobytes() for x in s.wave)
            if key not in waves:
                pad = None
                if self.moe is not None:   # the wave's bucket, as admitted
                    pad = max(8, 1 << (max(len(x) for x in s.wave) - 1)
                              .bit_length())
                waves[key] = (_Wave(list(s.wave), s.prompt_bits, pad, dev),
                              set())
            waves[key][1].add(s.row)
            conts.append(_Cont(s, waves[key][0], dev))
        alone = 0                   # a position with no step: its own id
        for c in conts:
            if c.steps is None:
                n = len(c.tokens)
                c.steps = -1 - alone - torch.arange(n, device=dev)
                alone += n
        wbits = ({w.bits[1] for w, _ in waves.values()}
                 | {b[1] for c in conts for b in c.groups})
        emb = self._images(p["embed"]["w"], wbits)
        for w, _ in waves.values():
            w.x = emb[w.bits[1]][w.tokens] * w.valid[..., None]
        for c in conts:
            c.x = torch.empty((len(c.tokens), m["d_model"]), device=dev)
            for (_, wb), idx in c.groups.items():
                c.x[idx] = emb[wb][c.tokens[idx]]
        del emb
        for l in range(m["n_layers"]):
            lw = self._layer_weights(l, wbits)
            for w, rows in waves.values():
                self._wave_layer(w, lw, rows)
            live = [c for c in conts if len(c.tokens)]
            for c in live:
                self._cont_attn(c, lw)
            if live:
                self._cont_ffn(live, lw)
            for w, _ in waves.values():
                w.kv = {}
            del lw
        if m.get("tie_embeddings"):
            head = {b: self.rnd(fq_tensor(p["embed"]["w"], b)).t()
                    for b in wbits}
        else:
            head = self._images(p["lm_head"]["w"], wbits)
        out = []
        zero = torch.zeros(1, dtype=torch.long, device=dev)
        for c in conts:
            if not c.s.want:
                continue
            w = c.wave
            h0 = self._norm(w.x[c.s.row, -1:], p["norm_f"]["g"])
            parts = [self._lin(h0, {w.bits: zero}, head)]
            if len(c.tokens):
                parts.append(self._lin(self._norm(c.x, p["norm_f"]["g"]),
                                       c.groups, head))
            out.append(torch.cat(parts))
        return out


def gap_stats(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per position: how far ``tokens``' logits lie below the row's best."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(1, tokens[:, None].long())[:, 0]
