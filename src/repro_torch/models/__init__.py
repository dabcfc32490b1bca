"""The dense decoder-only LM family: building blocks (``layers``), the
model and its serving steps (``transformer``), and parameter conversion
from the JAX reference (``convert``)."""
