"""Dataflow graphs of model function calls (paper §4, Fig. 4).

Nodes are *model function calls* — (model, call-type, workload) triples; edges
carry data dependencies.  Parameter-version dependencies (train_t must finish
before generation/inference_{t+1} on the same model) are implicit across
iterations and handled by the simulator/runtime when rolling the graph.

Builders are provided for PPO (the paper's main workflow), DPO, GRPO and
ReMax (§8.3, Fig. 16).

The port's copy of the JAX package's ``core/dfg.py`` (framework-free): it
computes the same numbers, and only its import paths differ.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ModelConfig

GENERATE = "generate"
INFERENCE = "inference"
TRAIN = "train"
CALL_TYPES = (GENERATE, INFERENCE, TRAIN)


@dataclasses.dataclass(frozen=True)
class Workload:
    """Token-level description of one call's work."""

    batch: int
    prompt_len: int = 0
    gen_len: int = 0
    n_minibatches: int = 1  # PPO minibatches: sequential update sub-steps
    # real token count for packed (cu_seqlens) training: when > 0, cost
    # lookups key on (1, total_tokens) instead of (batch, seq_len) — the
    # packed step's cost scales with real tokens, not the padded rectangle
    total_tokens: int = 0

    @property
    def seq_len(self) -> int:
        return self.prompt_len + self.gen_len


@dataclasses.dataclass(frozen=True)
class FunctionCall:
    name: str
    model_name: str  # models with the same name share parameters
    call_type: str
    config: ModelConfig
    workload: Workload
    inputs: tuple[str, ...] = ()
    outputs: tuple[str, ...] = ()
    trainable: bool = False  # whether this model holds optimizer state


@dataclasses.dataclass
class DataflowGraph:
    calls: list[FunctionCall]
    algorithm: str = "ppo"

    def __post_init__(self):
        self.by_name = {c.name: c for c in self.calls}
        assert len(self.by_name) == len(self.calls), "duplicate call names"

    def parents(self, call: FunctionCall) -> list[FunctionCall]:
        produced = {}
        for c in self.calls:
            for o in c.outputs:
                produced.setdefault(o, []).append(c)
        seen = []
        for i in call.inputs:
            for p in produced.get(i, []):
                if p.name != call.name and p not in seen:
                    seen.append(p)
        return seen

    def children(self, call: FunctionCall) -> list[FunctionCall]:
        return [c for c in self.calls if call in self.parents(c)]

    def edges(self) -> list[tuple[str, str]]:
        return [(p.name, c.name) for c in self.calls for p in self.parents(c)]

    def topo_order(self) -> list[FunctionCall]:
        order, done = [], set()
        pending = list(self.calls)
        while pending:
            progress = False
            for c in list(pending):
                if all(p.name in done for p in self.parents(c)):
                    order.append(c)
                    done.add(c.name)
                    pending.remove(c)
                    progress = True
            if not progress:
                raise ValueError("cycle in dataflow graph")
        return order

    def models(self) -> dict[str, ModelConfig]:
        out = {}
        for c in self.calls:
            out[c.model_name] = c.config
        return out

    def trainable_models(self) -> set[str]:
        return {c.model_name for c in self.calls if c.trainable}


# --------------------------------------------------------------- builders

def build_ppo(actor: ModelConfig, critic: ModelConfig, *, batch: int,
              prompt_len: int, gen_len: int, n_minibatches: int = 8,
              reward: Optional[ModelConfig] = None,
              ref: Optional[ModelConfig] = None,
              packed: bool = False,
              draft: Optional[ModelConfig] = None) -> DataflowGraph:
    """The paper's six-call PPO workflow (Fig. 4).  ``packed`` marks the
    train calls as running on the packed (total_tokens,) layout, so cost
    estimation keys them on real token counts (worst case at build time:
    batch * seq_len; runtime measurements refine per-total entries).

    ``draft`` adds speculative rollout: a seventh call, ``draft_gen``, runs
    the (frozen) draft model's proposal stream for the actor's generation.
    It is a first-class planned call — the searcher places it on its own
    sub-mesh and the simulator costs it and its realloc edges like any
    other model — with a data edge into ``actor_gen`` (the verify loop
    consumes the proposals), so the two overlap in time only through the
    runtime's cycle-level interleaving, never in the plan's dependency
    order."""
    reward = reward or critic
    ref = ref or actor
    gen = Workload(batch, prompt_len, gen_len)
    inf = Workload(batch, prompt_len, gen_len)
    trn = Workload(batch, prompt_len, gen_len, n_minibatches,
                   total_tokens=(batch * (prompt_len + gen_len)
                                 if packed else 0))
    actor_gen_inputs = ("prompts",) if draft is None \
        else ("prompts", "draft_seq")
    calls = []
    if draft is not None:
        calls.append(
            FunctionCall("draft_gen", "draft", GENERATE, draft, gen,
                         ("prompts",), ("draft_seq",)))
    calls += [
        FunctionCall("actor_gen", "actor", GENERATE, actor, gen,
                     actor_gen_inputs, ("seq", "logp", "gen_mask"),
                     trainable=True),
        FunctionCall("reward_inf", "reward", INFERENCE, reward, inf,
                     ("seq",), ("rewards",)),
        FunctionCall("ref_inf", "ref", INFERENCE, ref, inf,
                     ("seq",), ("ref_logp",)),
        FunctionCall("critic_inf", "critic", INFERENCE, critic, inf,
                     ("seq",), ("values",), trainable=True),
        FunctionCall("actor_train", "actor", TRAIN, actor, trn,
                     ("seq", "logp", "rewards", "ref_logp", "values",
                      "gen_mask"), ("actor_params",), trainable=True),
        FunctionCall("critic_train", "critic", TRAIN, critic, trn,
                     ("seq", "rewards", "values", "ref_logp", "logp",
                      "gen_mask"), ("critic_params",), trainable=True),
    ]
    return DataflowGraph(calls, "ppo")


def build_dpo(actor: ModelConfig, *, batch: int, prompt_len: int,
              gen_len: int, ref: Optional[ModelConfig] = None) -> DataflowGraph:
    """DPO: ref inference over paired responses, then policy training."""
    ref = ref or actor
    inf = Workload(batch * 2, prompt_len, gen_len)  # chosen + rejected
    trn = Workload(batch * 2, prompt_len, gen_len)
    calls = [
        FunctionCall("ref_inf", "ref", INFERENCE, ref, inf,
                     ("pairs",), ("ref_logp",)),
        FunctionCall("actor_train", "actor", TRAIN, actor, trn,
                     ("pairs", "ref_logp"), ("actor_params",), trainable=True),
    ]
    return DataflowGraph(calls, "dpo")


def build_grpo(actor: ModelConfig, *, batch: int, prompt_len: int,
               gen_len: int, group_size: int = 8,
               reward: Optional[ModelConfig] = None,
               ref: Optional[ModelConfig] = None) -> DataflowGraph:
    """GRPO: grouped generation (batch x group_size), no critic."""
    reward = reward or actor
    ref = ref or actor
    g = Workload(batch * group_size, prompt_len, gen_len)
    calls = [
        FunctionCall("actor_gen", "actor", GENERATE, actor, g,
                     ("prompts",), ("seq", "logp"), trainable=True),
        FunctionCall("reward_inf", "reward", INFERENCE, reward, g,
                     ("seq",), ("rewards",)),
        FunctionCall("ref_inf", "ref", INFERENCE, ref, g,
                     ("seq",), ("ref_logp",)),
        FunctionCall("actor_train", "actor", TRAIN, actor, g,
                     ("seq", "logp", "rewards", "ref_logp"),
                     ("actor_params",), trainable=True),
    ]
    return DataflowGraph(calls, "grpo")


def build_remax(actor: ModelConfig, *, batch: int, prompt_len: int,
                gen_len: int, reward: Optional[ModelConfig] = None,
                ref: Optional[ModelConfig] = None) -> DataflowGraph:
    """ReMax: two independent generations (sampled + greedy baseline) that can
    run concurrently — the paper's best-case algorithm for REAL (§8.3)."""
    reward = reward or actor
    ref = ref or actor
    gen = Workload(batch, prompt_len, gen_len)
    inf = Workload(batch, prompt_len, gen_len)
    calls = [
        FunctionCall("actor_gen", "actor", GENERATE, actor, gen,
                     ("prompts",), ("seq", "logp", "gen_mask"),
                     trainable=True),
        FunctionCall("actor_gen_greedy", "actor", GENERATE, actor, gen,
                     ("prompts",), ("seq_greedy",), trainable=True),
        FunctionCall("reward_inf", "reward", INFERENCE, reward, inf,
                     ("seq",), ("rewards",)),
        FunctionCall("reward_inf_baseline", "reward", INFERENCE, reward, inf,
                     ("seq_greedy",), ("rewards_baseline",)),
        FunctionCall("ref_inf", "ref", INFERENCE, ref, inf,
                     ("seq",), ("ref_logp",)),
        FunctionCall("actor_train", "actor", TRAIN, actor, inf,
                     ("seq", "logp", "rewards", "rewards_baseline", "ref_logp"),
                     ("actor_params",), trainable=True),
    ]
    return DataflowGraph(calls, "remax")


BUILDERS = {"ppo": build_ppo, "dpo": build_dpo, "grpo": build_grpo,
            "remax": build_remax}


# ------------------------------------------------- concatenated iterations

def base_name(name: str) -> str:
    """Call name with the unrolled-graph iteration suffix stripped:
    ``"actor_gen@3" -> "actor_gen"``.  Plain names pass through."""
    return name.split("@", 1)[0]


def iteration_of(name: str, default: int = 0) -> int:
    """Iteration index encoded in an unrolled call name (``default`` for
    plain, un-suffixed names)."""
    _, _, suffix = name.partition("@")
    return int(suffix) if suffix.isdigit() else default


def unroll_window(dfg: DataflowGraph, k: int, start: int = 0) -> DataflowGraph:
    """A ``k``-iteration window ``[start, start+k)`` of the concatenated
    graph.  Windows stitch: the first iteration of a ``start > 0`` window
    keeps its version-edge inputs referencing ``@{start-1}``, which have no
    producer *inside* the window — the scheduler (or a caller gluing two
    windows together) resolves them against the previous window's training
    outputs.  ``unroll_window(dfg, k, 0)`` is the full concatenated graph."""
    trainable = dfg.trainable_models()
    train_call_of = {c.model_name: c.name for c in dfg.calls
                     if c.call_type == TRAIN}
    calls = []
    for t in range(start, start + k):
        for c in dfg.calls:
            inputs = tuple(f"{i}@{t}" for i in c.inputs)
            outputs = tuple(f"{o}@{t}" for o in c.outputs)
            if t > 0 and c.model_name in trainable \
                    and c.model_name in train_call_of:
                inputs += (f"{c.model_name}_version@{t - 1}",)
            if c.call_type == TRAIN:
                outputs += (f"{c.model_name}_version@{t}",)
            calls.append(dataclasses.replace(
                c, name=f"{c.name}@{t}", inputs=inputs, outputs=outputs))
    return DataflowGraph(calls, dfg.algorithm + f"_x{k}")


def unroll_iterations(dfg: DataflowGraph, k: int) -> DataflowGraph:
    """The paper's concatenated graph G over k training iterations (§4):
    per-iteration data edges plus parameter-version edges — any call on a
    TRAINABLE model at iteration t+1 waits for that model's training at t;
    frozen-model calls (ref/reward) overlap freely across iterations."""
    return unroll_window(dfg, k, 0)
