"""Math RL examples."""
