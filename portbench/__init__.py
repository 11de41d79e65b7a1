"""The PyTorch port's benchmark: cells of (configuration, traffic mix),
run one at a time by ``portbench/run.py``. Nothing here imports JAX or the
JAX package; the plain reference (``portbench/reference.py``) imports
nothing of the port either."""
