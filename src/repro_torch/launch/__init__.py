"""Launchers of the port: ``train`` (the training entry point).  The
mesh, the sharded steps and the dry run wait for the port's distribution
module."""
