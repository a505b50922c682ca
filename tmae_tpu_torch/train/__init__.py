"""Finetune training of the port: optimizer, train step, checkpoints."""
