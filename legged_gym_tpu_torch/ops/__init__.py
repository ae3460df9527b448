"""Subpackage of legged_gym_tpu_torch."""
