"""The paper's tiny CNN (§4; port of ``repro/models/cnn.py``):
2 × [conv3×3·64 + ReLU + BN + maxpool] + FC.

Three quantizable layers, ``conv0``, ``conv1`` (the *inner* layer of the
``Mixed`` profile) and ``fc``, each with per-tensor dynamic fake-quant of
its input activations and weights (K5 on the card, with the
straight-through gradient under autograd). The native merged engine picks
one pre-quantized weight image per *distinct* spec, shared across
profiles (:func:`~repro_torch.core.engine.switch_images`), dequantizes it
to f32 and convolves, as the reference does (no K3: its native CNN calls no
``qmatmul``).

Parameters keep the reference's layouts, HWIO conv weights and NHWC
images, so :func:`~repro_torch.models.convert.params_from_jax` carries them
leaf for leaf and ``fc`` flattens (h, w, c) as there; only the convolution
sees NCHW/OIHW views. The convolution and the ``fc`` product are library
calls (the reference computes them outside any Pallas kernel). BN uses
batch statistics in train and eval alike, with the population variance
and eps 1e-5. Everything is f32, as the reference's CNN is on any device.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.engine import QuantIndex, switch_images
from repro_torch.core.merge import MergePlan
from repro_torch.core.qtypes import QuantSpec
from repro_torch.core.quantizers import (QTensor, dequantize,
                                         fake_quant_dynamic, quantize_native)
from repro_torch.kernels.aquant import aquant_ref
from repro_torch.runtime import resolve_device

__all__ = ["CNNConfig", "CNN_LAYERS", "CNN_INDEX", "init_cnn",
           "cnn_weight_shapes", "cnn_forward", "cnn_sites", "cnn_loss",
           "cnn_loss_and_grad", "cnn_accuracy", "quantize_cnn_images",
           "cnn_forward_native", "midpoint_distance",
           "tie_aware_check"]

CNN_LAYERS = ("conv0", "conv1", "fc")
CNN_INDEX = QuantIndex(CNN_LAYERS)


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    size: int = 28
    in_ch: int = 1
    channels: int = 64
    kernel: int = 3
    n_classes: int = 10

    @property
    def fc_in(self) -> int:
        return (self.size // 4) * (self.size // 4) * self.channels


def init_cnn(cfg: CNNConfig, gen: torch.Generator, device=None) -> dict:
    """He-scaled normal conv weights, 0.02-scaled ``fc``, zero biases, unit
    BN gains — the reference's init, drawn from ``gen`` on ``device``
    (CUDA unless ``device="cpu"``; ``gen`` lives on the same device)."""
    dev = resolve_device(device)
    kk, c = cfg.kernel, cfg.channels

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32)

    def conv_init(cin, cout):
        return {"w": normal(kk, kk, cin, cout) / math.sqrt(kk * kk * cin),
                "b": torch.zeros(cout, device=dev),
                "bn_g": torch.ones(cout, device=dev),
                "bn_b": torch.zeros(cout, device=dev)}

    return {"conv0": conv_init(cfg.in_ch, c),
            "conv1": conv_init(c, c),
            "fc": {"w": normal(cfg.fc_in, cfg.n_classes) * 0.02,
                   "b": torch.zeros(cfg.n_classes, device=dev)}}


def cnn_weight_shapes(cfg: CNNConfig) -> dict:
    kk, c = cfg.kernel, cfg.channels
    return {"conv0": (kk, kk, cfg.in_ch, c), "conv1": (kk, kk, c, c),
            "fc": (cfg.fc_in, cfg.n_classes)}


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3×3 ``SAME`` convolution, stride 1: NHWC × HWIO → NHWC, plus bias."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=w.shape[0] // 2)
    return y.permute(0, 2, 3, 1) + b


def _conv_bn(p: dict, xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """conv → ReLU → BN (batch statistics): the block before its pool."""
    y = torch.relu(_conv(xq, w, p["b"]))
    mu = y.mean(dim=(0, 1, 2), keepdim=True)
    var = y.var(dim=(0, 1, 2), keepdim=True, correction=0)
    return (y - mu) * torch.rsqrt(var + 1e-5) * p["bn_g"] + p["bn_b"]


def _conv_block(p: dict, x: torch.Tensor, bits_aw,
                w_override: torch.Tensor | None = None) -> torch.Tensor:
    """conv → ReLU → BN → 2×2 maxpool, quantizing input activations and
    weights."""
    xq = fake_quant_dynamic(x, bits_aw[0])
    w = w_override if w_override is not None else \
        fake_quant_dynamic(p["w"], bits_aw[1])
    return _pool(_conv_bn(p, xq, w))


def _pool(y: torch.Tensor) -> torch.Tensor:
    """2×2 ``VALID`` max-pool, NHWC (a tied window routes its gradient to
    its first maximum, as the reference's ``reduce_window`` does)."""
    return F.max_pool2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def cnn_sites(params: dict, bits_row, images: torch.Tensor,
              w_images: dict | None = None) -> dict:
    """The fake path with its activation-quantization sites exposed:
    ``{"conv0", "conv1", "fc"}`` → the tensor each layer's input quantizer
    sees (before quantization), and ``"logits"``. ``w_images`` replaces
    each layer's quantized weight (the native engine)."""
    w_images = w_images or {}
    bits = {ln: CNN_INDEX.gather(bits_row, [ln])[0] for ln in CNN_LAYERS}
    sites = {"conv0": images}
    sites["conv1"] = _conv_block(params["conv0"], images, bits["conv0"],
                                 w_images.get("conv0"))
    h = _conv_block(params["conv1"], sites["conv1"], bits["conv1"],
                    w_images.get("conv1"))
    sites["fc"] = h.reshape(h.shape[0], -1)
    fb = bits["fc"]
    xq = fake_quant_dynamic(sites["fc"], fb[0])
    wq = w_images["fc"] if "fc" in w_images else \
        fake_quant_dynamic(params["fc"]["w"], fb[1])
    sites["logits"] = xq @ wq + params["fc"]["b"]
    return sites


def cnn_forward(params: dict, bits_row, images: torch.Tensor) -> torch.Tensor:
    """QAT/fake path. images [B, H, W, C] → logits [B, n_classes]."""
    return cnn_sites(params, bits_row, images)["logits"]


def cnn_loss(params: dict, bits_row, batch: dict):
    logits = cnn_forward(params, bits_row, batch["images"])
    logp = torch.log_softmax(logits, dim=-1)
    labels = batch["labels"].long()
    nll = -torch.gather(logp, 1, labels[:, None]).mean()
    acc = (torch.argmax(logits, -1) == labels).float().mean()
    return nll, {"acc": acc}


def cnn_loss_and_grad(params: dict, bits_row, batch: dict):
    """``jax.value_and_grad(cnn_loss, has_aux=True)``: ``((loss, aux),
    grads)`` with ``grads`` shaped like ``params``. The parameters are
    used through detached leaves, so the caller's tensors stay as they
    are."""
    leaves = {ln: {k: v.detach().requires_grad_(True) for k, v in p.items()}
              for ln, p in params.items()}
    with torch.enable_grad():
        loss, aux = cnn_loss(leaves, bits_row, batch)
        flat = [v for p in leaves.values() for v in p.values()]
        grads = iter(torch.autograd.grad(loss, flat))
    return (loss.detach(), aux), {ln: {k: next(grads) for k in p}
                                  for ln, p in leaves.items()}


@torch.no_grad()
def cnn_accuracy(params: dict, bits_row, images, labels, batch: int = 512,
                 forward=None) -> float:
    """Test accuracy over whole batches of ``batch`` (the remainder is
    dropped, as in the reference); numpy inputs move to the parameters'
    device. ``forward(x) -> logits`` replaces the fake path (the native
    engine's accuracy)."""
    dev = params["fc"]["w"].device
    if forward is None:
        forward = lambda x: cnn_forward(params, bits_row, x)  # noqa: E731
    hits = 0
    for i in range(0, len(labels) - batch + 1, batch):
        lg = forward(torch.as_tensor(np.asarray(images[i:i + batch]),
                                     device=dev))
        hits += int((torch.argmax(lg, -1).cpu().numpy()
                     == np.asarray(labels[i:i + batch])).sum())
    n = (len(labels) // batch) * batch
    return hits / max(1, n)


# ---------------------------------------------------------------------------
# native merged engine (MDC datapath analogue)
# ---------------------------------------------------------------------------

def quantize_cnn_images(params: dict, plan: MergePlan) -> dict:
    """One integer weight image per *distinct* (a,w) spec per layer — the
    deduplicated 'actors' of the merged datapath. Float specs keep the
    master."""
    images: dict[str, list] = {}
    for ln in plan.layer_names:
        w = params[ln]["w"]
        imgs = []
        for (_, wb) in plan.distinct_specs[ln]:
            if wb >= 17:
                imgs.append(w)
            else:
                # per-tensor po2 scale: bit-exact with the QAT fake-quant grid
                imgs.append(quantize_native(w, QuantSpec(bits=wb,
                                                         po2_scale=True)))
        images[ln] = imgs
    return images


def cnn_forward_native(params: dict, images: dict, plan: MergePlan,
                       selectors, bits_row, x: torch.Tensor) -> torch.Tensor:
    """Runtime-switched native engine: ``selectors[i]`` (host ints) picks
    the weight image of layer i (from the merge plan); activations still
    follow ``bits_row``. Shared layers (one image) involve no switch."""

    def deq(im):
        return dequantize(im, torch.float32) if isinstance(im, QTensor) \
            else im

    w_images = {ln: switch_images(selectors[i], images[ln], deq)
                for i, ln in enumerate(CNN_LAYERS)}
    return cnn_sites(params, bits_row, x, w_images)["logits"]


def midpoint_distance(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``|x/s − (k + ½)|`` for the nearest k: how far each element lies
    from a rounding midpoint of its per-tensor ``bits`` grid (0 = a tie).
    Two computations of the same site may round differently only where
    this is small."""
    _, s = aquant_ref(x.float(), int(bits), po2=True, return_scale=True)
    r = (x.float() / s).abs()
    return (r - torch.floor(r) - 0.5).abs()


def tie_aware_check(ref: dict, got: dict, bits_row, tol: float = 1e-4,
                    fine_atol: float = 2e-3) -> dict:
    """Hold two runs of :func:`cnn_sites` (``ref`` first; any devices) to
    the tie rule, raising ``AssertionError`` where they break it.

    With every activation grid at 8 bits or fewer, the quantizers absorb
    the convolutions' and BN's summation-order noise: either no quantized
    activation differs (the logits then agree to 1e-5, bitwise where the
    ``fc`` sums are exact), or the first site whose quantized activations
    differ differs only at elements whose ``ref`` value lies within ``tol``
    of a grid midpoint (later sites inherit that flip) and the argmax
    agrees.
    A finer grid (A16) passes the noise through: logits within
    ``fine_atol``. Returns the per-site count of differing quantized
    elements."""
    cpu = {k: v.detach().float().cpu() for k, v in ref.items()}
    out = {k: v.detach().float().cpu() for k, v in got.items()}
    a_bits = {ln: int(CNN_INDEX.a_bits(bits_row, ln)) for ln in CNN_LAYERS}
    fine = max(a_bits.values()) > 8
    flips = {}
    for ln in CNN_LAYERS:
        if a_bits[ln] >= 17:
            continue
        diff = aquant_ref(cpu[ln], a_bits[ln]) != aquant_ref(out[ln],
                                                            a_bits[ln])
        flips[ln] = int(diff.sum())
        if flips[ln] and not fine and sum(flips.values()) == flips[ln]:
            dist = midpoint_distance(cpu[ln], a_bits[ln])[diff]
            assert float(dist.max()) < tol, (
                f"{ln}: {flips[ln]} quantized activations differ, one "
                f"{float(dist.max()):.3g} of a step from a midpoint")
    if fine:
        torch.testing.assert_close(out["logits"], cpu["logits"], rtol=0,
                                   atol=fine_atol)
    elif not any(flips.values()):        # only the fc product's order
        torch.testing.assert_close(out["logits"], cpu["logits"], rtol=1e-5,
                                   atol=1e-5)
    else:
        assert torch.equal(out["logits"].argmax(-1),
                           cpu["logits"].argmax(-1)), "argmax differs"
    return flips
