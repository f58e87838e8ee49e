"""Fixture: a serving step that counts itself and draws from torch's
global generator, and a runtime scalar flowing into it (never imported —
parsed only)."""
import torch


class ServeEngine:
    def __init__(self, model, temperature: float):
        self.model = model
        self.temperature = temperature
        self.steps = 0
        self._gen = torch.Generator()

    def _step(self, tokens, state):
        self.steps += 1              # trace-self-mutation
        logits, state = self.model(tokens, state)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        seeded = torch.multinomial(probs, 1, generator=self._gen)  # clean
        drawn = torch.multinomial(probs, 1)   # trace-nondeterminism
        return seeded, drawn, state

    def generate(self, prompts, state):
        # retrace-scalar-flow: a runtime int enters the step positionally
        return self._step(prompts, int(state.shape[0]))
