"""Sharding over a single-process device mesh (``launch.mesh``): the CF
row helpers and the port's two collectives (``sharding``)."""
