from .decision_transformer import (DecisionTransformer, DTOutput,
                                   StateEncoder, init_dt_params,
                                   make_dt_apply, make_dt_embed_apply,
                                   make_state_encode, transform_actions)
from .unet import ConvBlock, UNet, UNetDenoiser, random_unet_state_dict

__all__ = ["ConvBlock", "DTOutput", "DecisionTransformer", "StateEncoder",
           "UNet", "UNetDenoiser", "init_dt_params", "make_dt_apply",
           "make_dt_embed_apply", "make_state_encode",
           "random_unet_state_dict", "transform_actions"]
