"""Tier-1 test harness configuration (placeholder).

Batched-vs-sequential token parity is handled structurally in the engines:
XLA:CPU's threaded runtime can make float rounding depend on a request's
row position inside batched ops, so the paged decode step runs rows through
``lax.map`` on CPU (models/transformer.paged_decode_step) and batches are
padded to a fixed width bucket (serving/engine.BATCH_PAD) — every row
executes the same compiled body regardless of batch composition.
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; run with python -m pytest -m gpu tests/test_torch_gpu.py",
    )
