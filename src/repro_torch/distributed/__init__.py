"""Distribution on one card: sharding specs over logical meshes and the
ImaGen-planned pipeline schedule (the port of ``src/repro/distributed``)."""
