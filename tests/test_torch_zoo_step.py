"""One LAMB step of the transformer zoo's smoke configs against the JAX
package's: granite-moe (fused and as the transform chain, with the MoE aux
in the loss), granite-20b (its qkv biases exempt from decay and the trust
ratio), hubert (the masked-prediction loss, dense and fused head) and
paligemma (the image prefix)."""
import jax
import numpy as np
import pytest
import torch

from _torch_threads import one_cpu_thread  # noqa: F401
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import warmup_poly_decay as jax_warmup_poly_decay
from repro.data import synthetic as jax_synthetic
from repro.models import build_model as jax_build_model
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import warmup_poly_decay
from repro_torch.data import make_batch
from repro_torch.models import build_model
from repro_torch.nn import params_from_jax, state_from_jax
from repro_torch.train import TrainState, make_train_step
from repro_torch.train.step import _microbatch_grads, make_loss_fn
from test_torch_zoo import _j, _pair, _t

STEP_CASES = [
    ("granite-moe-1b-a400m", True, {}),
    ("granite-moe-1b-a400m", False, {}),
    ("granite-20b", True, {}),
    ("hubert-xlarge", True, {}),
    ("hubert-xlarge", True, dict(use_fused_ce_head=True, mlm_max_predictions=16)),
    ("paligemma-3b", True, {}),
]


@pytest.mark.parametrize("arch,fused,extra", STEP_CASES)
def test_one_lamb_step_matches_jax(arch, fused, extra):
    """One fp32 LAMB step (fused: the JAX package's Pallas kernels in
    interpret mode against K1/K2's plain version; else the transform chain)
    from the same state on the same batch, accumulation 2: the loss and its
    MoE terms to 1e-4, and every weight to 1e-3 as ``tests/test_torch_train.py``
    bounds them.  At the first step LAMB's direction m̂/(√v̂+ε) is nearly
    sign(g), so an element whose gradient is at the frameworks' fp32 noise
    may step the other way: at most 1% of a leaf's elements may differ by
    more than 1e-5 (one element of a (4, 32) bias is 0.8%)."""
    jcfg, cfg = _pair(arch, activation_dtype="float32")
    jcfg, cfg = jcfg.replace(**extra), cfg.replace(**extra)
    kw = dict(optimizer="lamb", use_fused_lamb=fused, accum_steps=2, learning_rate=0.01)
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
        assert float((diff > 1e-5).float().mean()) < 1e-2, k
        assert float(diff.max()) < 1e-3, k


@pytest.mark.parametrize("arch", ["hubert-xlarge", "granite-moe-1b-a400m", "bert-large"])
def test_only_declared_leaves_get_a_zero_gradient(arch):
    """The model declares the leaves its loss cannot reach (hubert's token
    embedding: its inputs are frame embeddings); they get a zero gradient as
    under ``jax.grad``.  Any other leaf cut off the loss is a wiring fault
    and raises instead of training on zeros."""
    cfg = smoke_config(arch).replace(activation_dtype="float32", use_flash_kernel=False,
                                     use_fused_ce_head=False)
    model = build_model(cfg)
    params = {k: v.requires_grad_() for k, v in model.init(0, "cpu").items()}
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch(cfg, np.random.default_rng(0), 2, 16).items()}
    unreachable = model.unreachable()
    assert unreachable == ({"embed"} if arch == "hubert-xlarge" else set())
    grads, _ = _microbatch_grads(make_loss_fn(model), params, batch, 1, unreachable)
    assert list(grads) == list(params)
    for k, g in grads.items():
        assert g.shape == params[k].shape and g.dtype == torch.float32, k
        assert (not bool(g.any())) == (k in unreachable), k
    # a leaf cut off the loss that the model does not declare
    cut = dict(params, **{"final_norm/scale": params["final_norm/scale"].detach()
                          .clone().requires_grad_()})
    loss_fn = make_loss_fn(model)
    with pytest.raises(RuntimeError, match="not have been used"):
        _microbatch_grads(lambda p, b: loss_fn(dict(p, **{"final_norm/scale":
                                                          params["final_norm/scale"]}), b),
                          cut, batch, 1, unreachable)
