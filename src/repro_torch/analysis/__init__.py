"""Static analysis over execution plans: ``analysis.verify``, the port's copy
of the JAX package's structural and capacity rules over a dataflow graph,
an execution plan and a cluster."""
