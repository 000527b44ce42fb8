"""Share of the card's FP32 peak (%) that the FLOPs a training step needs
(``roofline.step_flops``) take of the traced window's time per step."""

from benchmark import roofline


def read(run):
    return roofline.mfu(run)
