from .fused_optimizer import FP16_Optimizer
from .loss_scaler import DynamicLossScaler, LossScaler
from .unfused_optimizer import FP16_UnfusedOptimizer
