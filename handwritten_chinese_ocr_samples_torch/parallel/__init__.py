"""Process groups, data devices and row shards (``mesh``)."""
