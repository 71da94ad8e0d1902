"""Distributed training pieces of the port. Only the int8 gradient
compression with error feedback (``compression``) is ported; sharding,
collectives and elastic re-meshing are not."""
