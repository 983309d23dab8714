"""Supervised finetuning examples."""
