from .transformer import (DeepSpeedTransformerConfig,
                          DeepSpeedTransformerLayer, TransformerConfig)
