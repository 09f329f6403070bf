"""Training for the port: the JAX package's ``training/`` in PyTorch.

``data`` (the seeded synthetic token stream, a numpy copy: batches are
bitwise the reference's), ``optimizer`` (AdamW with fp32, bf16 or
blockwise-int8 moments), ``compression`` (blockwise-int8 gradient
compression with error feedback), ``checkpoint`` (the reference's on-disk
format: a JAX checkpoint restores here) and ``train_loop`` (``Trainer``,
``StragglerMonitor``, ``Trainer(mesh=)`` for the sharded step).  The
sharded pieces: ``optimizer.opt_state_pspecs`` and
``compression.compressed_psum``.
"""
