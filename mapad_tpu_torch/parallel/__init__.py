from .sharding import make_mesh, shard_search_inputs  # noqa: F401
