"""Reward-model examples."""
