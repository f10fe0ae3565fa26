"""Pooling one bag in pieces (:mod:`.bag_shard`)."""
