"""Adaptation and training steps, the trainers, hooks and pseudo-label probes."""
