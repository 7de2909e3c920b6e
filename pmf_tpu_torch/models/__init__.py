from .modules import ConvUpSample, CSAttention
from .epmf import EPMFNet, RGBDecoderV2, SalsaNextFusionV2, SparseResContextBlock, SparseVariantConv
from .convert import (load_pretrained_resnet, load_weights, random_weights, read_flax_npz,
                      state_dict_from_flax)
from .pmf import ASPP, PMFNet, build_model, ResidualBasedFusionBlock, RGBDecoder, SalsaNextFusion
from .resnet import ResNetEncoder
from .salsanext import ResBlock, ResContextBlock, SalsaNext, UpBlock
