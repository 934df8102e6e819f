"""Sharding rules of the port as DTensor placements (``sharding``)."""
