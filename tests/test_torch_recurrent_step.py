"""One LAMB step of the recurrent families' smoke configs (xLSTM and
Jamba, through the dense CE) against the JAX package's ``make_train_step``,
on bridged weights and state and the same batch."""
import jax
import numpy as np
import pytest

from _torch_threads import one_cpu_thread  # noqa: F401
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import warmup_poly_decay as jax_warmup_poly_decay
from repro.data import synthetic as jax_synthetic
from repro.models import build_model as jax_build_model
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs.base import TrainConfig
from repro_torch.core import warmup_poly_decay
from repro_torch.models import build_model
from repro_torch.nn import params_from_jax, state_from_jax
from repro_torch.train import TrainState, make_train_step
from test_torch_recurrent import ARCHS, _j, _pair, _t


@pytest.mark.parametrize("arch", ARCHS)
def test_one_lamb_step_matches_jax(arch):
    """One fp32 fused LAMB step (the JAX package's Pallas kernels in
    interpret mode against K1/K2's plain version) from the same state on the
    same batch, accumulation 2, through the dense CE: the loss (and Jamba's
    MoE terms) to 1e-4 and every weight as tests/test_torch_zoo_step.py
    bounds them (1e-3, at most 1% of a leaf past 1e-5: LAMB's first
    direction is nearly sign(g), so an element whose gradient is at the
    frameworks' fp32 noise may step otherwise), or 2 elements of a small
    leaf (xlstm-smoke's 128-element norm scales, where 1% is one: its two
    have gradients 1e-3 and 1e-4 of the leaf's median)."""
    jcfg, cfg = _pair(arch, activation_dtype="float32")
    kw = dict(optimizer="lamb", use_fused_lamb=True, accum_steps=2, learning_rate=0.01)
    jmodel = jax_build_model(jcfg)
    jinit, jstep = jax_make_train_step(jmodel, JaxTrainConfig(fused_backend="interpret", **kw),
                                       jax_warmup_poly_decay(0.01, 10, 0))
    _, step = make_train_step(build_model(cfg), TrainConfig(**kw), warmup_poly_decay(0.01, 10, 0))
    jstate = jinit(jax.random.key(0))
    state = TrainState(params_from_jax(jstate.params), state_from_jax(jstate.opt_state))
    batch = next(jax_synthetic.batch_iterator(jcfg, 4, 16, seed=1))
    jstate, jm = jax.jit(jstep)(jstate, _j(batch))
    state, m = step(state, _t(batch))
    assert sorted(k for k in m if "/" in k) == sorted(k for k in jm if "/" in k)
    for k in ("loss/total", "loss/ce", "loss/moe_lb", "moe/drop_fraction", "update_norm",
              "tokens/supervised"):
        if k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    assert float(m["update_norm"]) > 0
    for k, v in params_from_jax(jstate.params).items():
        diff = (state.params[k] - v).abs()
        assert int((diff > 1e-5).sum()) <= max(2, 1e-2 * diff.numel()), k
        assert float(diff.max()) < 1e-3, k
