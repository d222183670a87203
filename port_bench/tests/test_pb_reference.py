"""The plain reference against the program at smoke size on the CPU (the
test imports both; the reference imports nothing of the program)."""
import numpy as np
import torch

from conftest import smoke_cell
from pb_reference import Reference, Served, profile_bits
from pb_serve import model_config
from pb_weights import make_params


def _program(cell):
    from repro_torch.core.engine import AdaptiveEngine, QuantIndex
    from repro_torch.core.profiles import paper_profiles
    from repro_torch.models import transformer as T
    cfg = model_config(cell.config["model"])
    names = T.quant_layer_names(cfg)
    eng = AdaptiveEngine(tuple(paper_profiles(names, inner_layers=[])),
                         QuantIndex(names))
    return T, cfg, eng


def test_reference_imports_nothing_of_the_program():
    import pb_reference
    src = open(pb_reference.__file__).read()
    assert "repro_torch" not in src.replace("the program", "")


def test_dense_forward_matches_the_program_at_every_profile():
    cell = smoke_cell("granite-3-2b.chat")
    m = cell.config["model"]
    p = make_params(m, 11, torch.device("cpu"))
    T, cfg, eng = _program(cell)
    toks = np.random.default_rng(0).integers(0, m["vocab"], 30)
    for pid, name in enumerate(eng.profile_names):
        h, _, _ = T.forward(p, cfg, eng.table[pid],
                            {"tokens": torch.as_tensor(toks[None]).long()})
        prog = T._logits(cfg, p, eng.table[pid], h[:, 9:])[0].float()
        b = profile_bits(name)
        ref = Reference(m, p).logits(
            [Served([toks[:10]], 0, toks[10:], b, [b] * 20)])[0]
        assert torch.allclose(prog, ref, atol=1e-4), name


def test_moe_wave_prefill_matches_the_program():
    """A wave of three prompts, left-padded to its bucket with a pad row:
    the reference's first-token logits of each row equal the program's
    ragged prefill (capacity drops and the buffers' scales included)."""
    cell = smoke_cell("qwen2-moe-a2.7b.chat")
    m = cell.config["model"]
    p = make_params(m, 12, torch.device("cpu"))
    T, cfg, eng = _program(cell)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, m["vocab"], n) for n in (13, 29, 7)]
    bucket = 32
    toks = np.zeros((4, bucket), np.int64)
    for j, pr in enumerate(prompts):
        toks[j, bucket - len(pr):] = pr
    plen = [len(x) for x in prompts] + [0]
    pid = eng.profile_names.index("A8-W8")
    logits, _ = T.prefill(p, cfg, eng.table[pid],
                          {"tokens": torch.as_tensor(toks),
                           "prompt_len": plen}, 64)
    wave = prompts + [np.zeros(0, np.int64)]
    b = profile_bits("A8-W8")
    ref = Reference(m, p).logits([Served(wave, j, np.zeros(0, np.int64),
                                         b, []) for j in range(3)])
    for j in range(3):
        assert torch.allclose(logits[j].float(), ref[j][0], atol=1e-4)


def test_moe_decode_step_shares_its_buffers_scale_across_rows():
    """A decode step fake-quantizes its MoE dispatch buffers with one
    scale over every live row: a row's logits move with the other rows
    (here by 0.02), and the reference, given the step each position ran
    in, follows the program's step; alone, it follows the row alone."""
    import copy
    cell = smoke_cell("qwen2-moe-a2.7b.chat")
    m = cell.config["model"]
    p = make_params(m, 12, torch.device("cpu"))
    T, cfg, eng = _program(cell)
    pid = eng.profile_names.index("A8-W8")
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, m["vocab"], n) for n in (13, 29, 7, 20)]
    toks = np.zeros((4, 32), np.int64)
    for j, pr in enumerate(prompts):
        toks[j, 32 - len(pr):] = pr
    plen = [len(x) for x in prompts]
    first, caches = T.prefill(p, cfg, eng.table[pid],
                              {"tokens": torch.as_tensor(toks),
                               "prompt_len": plen}, 64, kv_bits=32)
    t0 = first.argmax(-1)
    prog = {}
    for n_live in (4, 1):
        live = torch.arange(4) < n_live
        out, _ = T.decode_step(p, cfg, eng.table[pid], t0[:, None],
                               torch.as_tensor(plen, dtype=torch.int32),
                               copy.deepcopy(caches), row_valid=live)
        prog[n_live] = out[0].float()
    assert (prog[4] - prog[1]).abs().max() > 1e-2
    b = profile_bits("A8-W8")
    for n_live, steps in ((4, np.zeros(1, np.int64)), (1, None)):
        ref = Reference(m, p).logits(
            [Served(prompts, j, np.asarray([int(t0[j])]), b, [b], steps,
                    j == 0) for j in range(n_live)])[0][1]
        assert torch.allclose(ref, prog[n_live], atol=1e-4), n_live
