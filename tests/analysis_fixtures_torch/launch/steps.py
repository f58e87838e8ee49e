"""Fixture: trace-purity and retrace violations in torch's idiom, at the
path and names of three ``TRACE_ROOTS`` rows (never imported — parsed
only)."""
import torch

_LOG = []
_COUNT = 0


def _bump():
    global _COUNT                    # trace-global-state (reached from a root)
    _COUNT += 1


class _Noisy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return g * torch.rand_like(g)    # trace-nondeterminism, via .apply


def make_train_step(opt):
    gen = torch.Generator()

    def train_step(params, batch, flag, n_steps: int):  # retrace-scalar-arg
        if flag:                     # trace-host-branch: `flag` not static
            batch = batch + 1
        noise = torch.randn(batch.shape)    # trace-nondeterminism
        noise.uniform_()                    # trace-nondeterminism
        seeded = torch.randn(batch.shape, generator=gen)     # clean
        seeded.normal_(generator=gen)                         # clean
        _LOG.append(noise)           # trace-mutation (closed-over list)
        _bump()
        return opt(params, _Noisy.apply(batch * noise * seeded), n_steps)

    return train_step


def make_serve_step(model):
    def serve_step(params, tokens, state):       # clean
        logits, state = model(params, tokens, state)
        return torch.argmax(logits, dim=-1), state

    return serve_step


def make_prefill_step(model):
    def prefill_step(params, tokens, state):     # clean
        logits, state = model(params, tokens, state)
        return torch.argmax(logits, dim=-1), state

    return prefill_step
