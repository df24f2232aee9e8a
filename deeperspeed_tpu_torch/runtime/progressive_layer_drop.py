"""Progressive layer dropping (reference:
`deepspeed/runtime/progressive_layer_drop.py:5`).

A copy of `deeperspeed_tpu/runtime/progressive_layer_drop.py`:
theta(t) = (1 - p) * e^{-gamma t} + p, the keep-probability schedule.
The engine hands theta of the current ``global_steps`` to a model whose
``loss_fn`` declares a ``pld_theta`` argument, and keeps this holder's
``current_theta`` at the value of the last step boundary.
"""

import numpy as np


class ProgressiveLayerDrop:
    """State holder for the PLD theta schedule."""

    def __init__(self, theta=0.5, gamma=0.001):
        self.theta = theta
        self.gamma = gamma
        self.current_theta = 1.0

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self):
        return self.current_theta

    def update_state(self, global_step):
        def _prob(x, gamma, p):
            return (1.0 - p) * np.exp(-gamma * x) + p

        self.current_theta = _prob(global_step, self.gamma, self.theta)
