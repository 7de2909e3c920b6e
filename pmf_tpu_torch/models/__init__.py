from .convert import load_weights, random_weights, read_flax_npz, state_dict_from_flax
from .pmf import ASPP, PMFNet, build_model, ResidualBasedFusionBlock, RGBDecoder, SalsaNextFusion
from .resnet import ResNetEncoder
from .salsanext import ResBlock, ResContextBlock, SalsaNext, UpBlock
