"""The port's plan searches against the JAX package's: the symmetric
heuristic and ``mcmc_search`` over two pipelined iterations (one iteration
is held in ``test_torch_core.py``), by exact equality of the best plan and its
time (the copies draw from the same ``random.Random`` seeds over the same
candidate order with the same float arithmetic).  The graphs and clusters
are ``test_torch_core.py``'s: the four configs the port serves, full and
reduced, on 16 prompts of 128 tokens and 256 new on ``Cluster(2, 4)``.
"""

import pytest

from repro.core import estimator as JE
from repro.core import search as JS
from repro_torch.core import estimator as TE
from repro_torch.core import search as TS
from test_torch_core import CASES, check_mcmc, clusters, graphs, plan_key


@pytest.mark.parametrize("arch,reduced", CASES)
def test_heuristic_plan_equals_jax(arch, reduced):
    """The symmetric heuristic's plan, or the same refusal where no
    symmetric plan fits the v5e's memory."""
    jcl, tcl = clusters()
    jg, tg = graphs(arch, reduced)
    try:
        want = JS.heuristic_plan(jg, jcl, JE.CostModel(jcl))
    except ValueError as err:
        with pytest.raises(ValueError, match=str(err)):
            TS.heuristic_plan(tg, tcl, TE.CostModel(tcl))
        return
    assert plan_key(TS.heuristic_plan(tg, tcl, TE.CostModel(tcl))) == plan_key(want)


@pytest.mark.parametrize("arch,reduced", CASES)
def test_pipelined_mcmc_search_equals_jax(arch, reduced):
    """``mcmc_search(iters=200, pipeline_iters=2)``, ranking plans on the
    steady-state time of the unrolled graph: the best plan, its time, the
    evaluation count and the static pruning, for 3 seeds."""
    check_mcmc(arch, reduced, pipeline_iters=2)
