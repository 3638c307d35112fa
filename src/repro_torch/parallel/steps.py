"""The single-device train step of the JAX package's ``parallel/steps.py``
(its sharded steps, prefill and decode wait for physical resharding across
cards, ROADMAP Queue 1 item 5).  The profiler measures this step."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as MDL
from repro_torch.optim import adamw
from repro_torch.optim.grad import accumulate_grads


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, *, impl="cuda", remat=True,
                    n_micro: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics): the LM
    loss's gradient over ``n_micro`` microbatches, then one AdamW update
    (in place).  The parameters must require grad."""

    def loss_fn(params, batch):
        return MDL.lm_loss(params, cfg, batch, impl=impl, remat=remat)

    def step(params, opt_state, batch):
        loss, grads, aux = accumulate_grads(loss_fn, params, batch, n_micro)
        params, opt_state, stats = adamw.update(opt_cfg, params, opt_state, grads)
        return params, opt_state, {"loss": loss, **aux, **stats}

    return step
