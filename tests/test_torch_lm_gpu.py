"""The port's LM training slice on a CUDA card only (``-m gpu``; every test
skips without a card).  Needs torch and no jax, so it runs on the GPU host:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lm_gpu.py

The unbind layer loop's gradients on the card against the CPU's (rtol
1e-4, atol 1e-5, the tolerance of ``chip_smoke.py``'s card-vs-CPU
phases: cuBLAS and the CPU sum the f32 matmuls in other orders, through
six layers; TF32 off), a bf16 checkpoint round trip of card tensors (bit for bit),
a reduced ``train_loop`` on the card against the CPU (losses rtol 1e-4),
and the reduced recurrent families (xlstm-125m, zamba2-2.7b) on the card
against the CPU: loss rtol 1e-4, gradients rtol 1e-4 and atol 1e-5
(xLSTM's atol 1e-4: on the CPU alone, f32 gradients of its tied embedding
sit up to 4.7e-5 from an f64 evaluation), decode logits over a prompt and
three tokens rtol 1e-4, atol 1e-5; the same for the reduced MoE configs
(deepseek-v2-236b with MLA, arctic-480b), and a bf16 MoE layer served
twice on the card bit for bit, its combine equal to the CPU's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import requires_cuda  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import scan_util  # noqa: E402
from repro_torch.models.lm import get_model  # noqa: E402


@pytest.fixture
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.gpu
def test_unbind_loop_gradients_on_card_match_cpu(no_tf32):
    dev = requires_cuda()
    rng = np.random.default_rng(0)
    stack = {"w": rng.standard_normal((6, 32, 32)).astype(np.float32) / 6,
             "s": rng.standard_normal((6, 32)).astype(np.float32)}
    x0 = rng.standard_normal((4, 32)).astype(np.float32)

    def body(h, bp):
        return torch.tanh(h @ bp["w"]) * (1 + bp["s"]), None

    grads = []
    for device in ("cpu", dev):
        leaves = {k: torch.from_numpy(v).to(device).requires_grad_(True)
                  for k, v in stack.items()}
        out, _ = scan_util.scan(body, torch.from_numpy(x0).to(device), leaves)
        g = torch.autograd.grad(out.square().sum(), [leaves["s"],
                                                     leaves["w"]])
        grads.append([t.cpu() for t in g])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_bf16_checkpoint_round_trip_of_card_tensors(tmp_path):
    dev = requires_cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    tree = ({"w": torch.randn((3, 5), generator=g, device=dev).to(
        torch.bfloat16)}, {"step": 7})
    ckpt.save_checkpoint(tmp_path, 1, tree)
    got, step, _ = ckpt.load_checkpoint(tmp_path, tree)
    assert step == 1 and got[1]["step"] == 7
    assert got[0]["w"].device == tree[0]["w"].device
    assert got[0]["w"].dtype == torch.bfloat16
    assert torch.equal(got[0]["w"].view(torch.int16),
                       tree[0]["w"].view(torch.int16))


@pytest.mark.gpu
def test_reduced_train_loop_on_card_matches_cpu(tmp_path, no_tf32,
                                                monkeypatch):
    """A reduced gemma (f32) ``train_loop`` of 3 steps on the card and on
    the CPU from the same seed: the same losses within rtol 1e-4; then a
    bf16 run on the card resumes from its step-2 checkpoint."""
    requires_cuda()
    cfg = configs.get_config("gemma-2b").reduced()
    kw = dict(steps=3, batch=2, seq_len=16, log_every=0)
    losses = {}
    params = get_model(cfg).init(0, device="cpu")
    model = dataclasses.replace(
        get_model(cfg), init=lambda seed=0, device=None: scan_util.tree_map(
            lambda t: t.to(device, copy=True), params))    # updated in place
    with monkeypatch.context() as m:
        m.setattr(train_mod, "get_model", lambda c: model)
        for device in ("cpu", "cuda"):
            losses[device] = train_mod.train_loop(cfg, device=device,
                                                  **kw).losses
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    full = train_mod.train_loop(bf16, ckpt_dir=tmp_path / "a", ckpt_every=2,
                                **kw)
    train_mod.train_loop(bf16, ckpt_dir=tmp_path / "b", ckpt_every=2,
                         **dict(kw, steps=2))
    resumed = train_mod.train_loop(bf16, ckpt_dir=tmp_path / "b",
                                   ckpt_every=2, resume=True, **kw)
    assert resumed.resumed_from == 2
    np.testing.assert_allclose(resumed.losses, full.losses[2:], rtol=2e-3)


RECURRENT_GRAD_TOL = {"xlstm-125m": dict(rtol=1e-4, atol=1e-4),
                      "zamba2-2.7b": dict(rtol=1e-4, atol=1e-5)}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", list(RECURRENT_GRAD_TOL))
def test_recurrent_loss_grads_and_decode_on_card_match_cpu(arch, no_tf32):
    _loss_grads_and_decode_card_vs_cpu(arch, RECURRENT_GRAD_TOL[arch])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "arctic-480b"])
def test_moe_loss_grads_and_decode_on_card_match_cpu(arch, no_tf32):
    """Reduced deepseek (MLA, shared experts) and arctic (dense residual):
    the capacity routing keeps the same tokens on both devices."""
    _loss_grads_and_decode_card_vs_cpu(arch, dict(rtol=1e-4, atol=1e-5))


@pytest.mark.gpu
def test_moe_forward_on_card_is_deterministic():
    """A bf16 MoE layer (reduced deepseek widened to 32 experts, top 6, so
    a token's sum has up to 6 terms) over 512 tokens, twice on the card:
    bit for bit, and the combine equals the CPU's scatter order (the
    CPU's combine on the card's expert outputs)."""
    dev = requires_cuda()
    from repro_torch.models import moe
    from repro_torch.models.common import make_generator
    base = configs.get_config("deepseek-v2-236b").reduced()
    cfg = dataclasses.replace(base, dtype="bfloat16", moe=dataclasses.replace(
        base.moe, num_experts=32, top_k=6))
    p = moe.init_moe(make_generator(0, dev), cfg)
    gen = make_generator(1, dev)
    x = torch.randn((4, 128, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        a = moe.moe_forward(p, cfg, x)
        b = moe.moe_forward(p, cfg, x)
        xt = x.reshape(-1, cfg.d_model)
        top_aff, top_idx = moe.route(xt, p["router"], cfg, 32, 0)
        y_e = torch.randn((*top_idx.shape, cfg.d_model), generator=gen,
                          device=dev)
        y_e = (y_e * top_aff[..., None]).to(torch.bfloat16)
        card = moe.combine(y_e, top_aff, top_idx, xt.shape[0], 6)
        cpu = moe.combine(y_e.cpu(), top_aff.cpu(), top_idx.cpu(),
                          xt.shape[0], 6)
    assert torch.equal(a, b)
    assert torch.equal(card.cpu(), cpu)


def _loss_grads_and_decode_card_vs_cpu(arch: str, grad_tol: dict) -> None:
    """The reduced ``arch`` (remat) on the card against the CPU from the
    same parameters: loss rtol 1e-4, every gradient within ``grad_tol``,
    decode logits over a 16-token prompt and three tokens rtol 1e-4,
    atol 1e-5."""
    dev = requires_cuda()
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.scan_util import tree_leaves, tree_map
    cfg = dataclasses.replace(configs.get_config(arch).reduced(), remat=True)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 19)).astype(np.int32)
    out = {}
    for device in ("cpu", dev):
        p = tree_map(lambda t: t.to(device), params)
        t = torch.from_numpy(toks).to(device)
        loss, grads = value_and_grad(model.loss, p, {"tokens": t[:, :16]})
        state = (model.decode_init(2, device=device) if cfg.xlstm
                 else model.decode_init(2, 24, device=device))
        logits = []
        with torch.inference_mode():
            for feed in (t[:, :16], t[:, 16:17], t[:, 17:18], t[:, 18:]):
                lg, state = model.decode_step(p, feed, state)
                logits.append(lg.cpu())
        out[str(device)] = (loss.cpu(), [g.cpu() for g in tree_leaves(grads)],
                            torch.stack(logits))
    (lc, gc, dc), (lg_, gg, dg) = out["cpu"], out[str(dev)]
    torch.testing.assert_close(lg_, lc, rtol=1e-4, atol=0)
    for a, b in zip(gc, gg):
        torch.testing.assert_close(b, a, **grad_tol)
    torch.testing.assert_close(dg, dc, rtol=1e-4, atol=1e-5)
