"""The decoder-only LM family, dense and MoE: building blocks
(``layers``), the model and its serving steps (``transformer``), and
parameter conversion from the JAX reference (``convert``)."""
