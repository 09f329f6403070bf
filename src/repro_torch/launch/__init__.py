"""Launchers of the port: ``train`` (the training entry point), ``mesh``
(the production and debug meshes), ``steps`` (the sharded train, prefill
and decode steps of every cell) and ``dryrun`` (the multi-pod dry run on
a fake process group)."""
