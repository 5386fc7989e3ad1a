"""Datasets: synthetic datagen, npz shards, batching."""
