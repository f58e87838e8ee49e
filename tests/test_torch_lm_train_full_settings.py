"""Both packages' ``train_loop`` at reduced width under the settings of the
port's full-width training runs on the card: lr 3e-4, AdamW's
``clip_norm`` 1.0 and no warmup (``launch/train.py::train_loop``'s
defaults), 3 steps, from the reference's parameters, for deepseek-v2-236b,
starcoder2-7b and gemma-2b (f32, batch 2 x 64).

At full width those runs' losses rise after an AdamW step (deepseek at 2
of 60 layers 12.76 -> 29.38 -> 26.87).  Adam moves every weight by about
lr a step whatever its gradient's size, so a pre-activation over d inputs
moves by about lr·d times an input's size: 1.5 at deepseek's d = 5,120,
0.02 at the reduced 64.  So each arch also runs with lr scaled by its
published width over the reduced one, which keeps lr·d at the full
width's.  Either way the port's losses are the reference's within rtol
1e-5 (``tests/test_torch_lm_train.py``'s ``LOSS_RTOL``), and rise or fall
alike at every step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import train as jtrain_mod  # noqa: E402
from repro.models.lm import get_model as jget_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models.lm import get_model  # noqa: E402
from repro_torch.models.lm_params import params_from_numpy  # noqa: E402

LOSS_RTOL = 1e-5
LR = 3e-4
ARCHS = ("deepseek-v2-236b", "starcoder2-7b", "gemma-2b")


@pytest.mark.parametrize("lr_at_width", [False, True],
                         ids=["lr", "lr-times-width"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loop_at_the_full_width_settings_matches_reference(
        monkeypatch, arch, lr_at_width):
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = configs.get_config(arch).reduced()
    jp = jget_model(jcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    jmodel = dataclasses.replace(jget_model(jcfg), init=lambda key: jp)
    tmodel = dataclasses.replace(
        get_model(tcfg), init=lambda seed=0, device=None: params_from_numpy(
            np_params, device=device))
    monkeypatch.setattr(jtrain_mod, "get_model", lambda cfg: jmodel)
    monkeypatch.setattr(train_mod, "get_model", lambda cfg: tmodel)
    lr = LR * (configs.get_config(arch).d_model / tcfg.d_model
               if lr_at_width else 1)
    kw = dict(steps=3, batch=2, seq_len=64, lr=lr, log_every=0)
    want = jtrain_mod.train_loop(jcfg, **kw).losses
    got = train_mod.train_loop(tcfg, device="cpu", **kw).losses
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert np.array_equal(np.sign(np.diff(got)), np.sign(np.diff(want)))
