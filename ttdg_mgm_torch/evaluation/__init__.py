"""Evaluation: Dice / E-measure / S-measure, COCO AP, VOC mAP and the
evaluator dispatch."""
