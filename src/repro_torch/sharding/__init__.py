"""Sharding rules of the port (``rules``): the reference's PartitionSpec
trees as plain data, and their DTensor placements."""
