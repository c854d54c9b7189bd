"""Detector modules: ResNet and VGG trunks, FPN, RPN, ROI heads and ``MaskRCNN``."""
