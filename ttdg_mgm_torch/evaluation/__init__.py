"""Evaluation: Dice / E-measure / S-measure and the evaluator dispatch."""
