"""Device meshes and stream-pool sharding (port of ``repro/distributed``)."""
