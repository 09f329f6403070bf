"""The port's benchmark driver and its benches: the counterparts of the
JAX package's ``benchmarks/*.py``, one module each under the reference's
name (``bench_connector_gates.py`` -> ``connector_gates``).  The gates,
traffic and repetition counts are the reference's; the model is
full-width qwen3-1.7b on the card, ``--device cpu --reduced`` in the CPU
tests.  Every output lands under ``results/torch/``.

    PYTHONPATH=src python -m repro_torch.bench.run                 # card
    PYTHONPATH=src python -m repro_torch.bench.chaos --fast --device cpu --reduced
"""
