from .arniqa import (ARNIQA, ResNet50, make_value_fn, make_value_fn_batched,
                     proxy_value_fn, proxy_value_fn_batched,
                     random_arniqa_state_dict, score_images)
from .decision_transformer import (Attention, Block, DecisionTransformer,
                                   DTOutput, LayerNorm, StateEncoder,
                                   fused_forward_takes, init_dt_params,
                                   make_dt_apply,
                                   make_dt_embed_apply, make_fused_dt_apply,
                                   make_state_encode, transform_actions)
from .drunet import DRUNet, DRUNetDenoiser, random_drunet_state_dict
from .prior_graphs import PriorGraphs
from .restormer import (Restormer, RestormerDenoiser,
                        random_restormer_state_dict)
from .unet import ConvBlock, UNet, UNetDenoiser, random_unet_state_dict

__all__ = ["ARNIQA", "Attention", "Block", "ConvBlock", "DRUNet",
           "DRUNetDenoiser", "DTOutput", "DecisionTransformer", "LayerNorm",
           "PriorGraphs", "ResNet50", "Restormer", "RestormerDenoiser",
           "StateEncoder", "UNet", "UNetDenoiser",
           "fused_forward_takes", "init_dt_params", "make_dt_apply",
           "make_dt_embed_apply", "make_fused_dt_apply", "make_state_encode",
           "make_value_fn", "make_value_fn_batched", "proxy_value_fn",
           "proxy_value_fn_batched", "random_arniqa_state_dict",
           "random_drunet_state_dict", "random_restormer_state_dict",
           "random_unet_state_dict",
           "score_images", "transform_actions"]
