"""Share of the card's FP32 peak (%) that the FLOPs a frame needs
(``roofline.step_flops``) take of the traced window's time per frame."""

from benchmark import roofline


def read(run):
    return roofline.mfu(run)
