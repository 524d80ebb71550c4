"""Parameter shapes of the neural pixelizer, in the JAX package's layout
(HWIO convs, (I, O) linears, (k, k, I, O) modulated convs), and
``random_params``: the JAX package's random weights, drawn number for
number as it draws them.

C2PGen(3, 3, 64, n_down=2, n_res=4, style=256, mlp=256) and
AliasNet(3, 3, 64, 2, 3). ``random_params(seed)`` draws from one
``np.random.RandomState(seed)`` in the dicts' order, so the same seed gives
the same model in both packages once ``convert.state_from_jax`` carries it
into the port's layout.
"""

import numpy as np

GEN_SHAPES = {
    "MLP.model.0.fc.bias": (256,),
    "MLP.model.0.fc.weight": (256, 256),
    "MLP.model.1.fc.bias": (256,),
    "MLP.model.1.fc.weight": (256, 256),
    "MLP.model.2.fc.bias": (256,),
    "MLP.model.2.fc.weight": (256, 256),
    "MLP.model.3.fc.bias": (2048,),
    "MLP.model.3.fc.weight": (256, 2048),
    "PBEnc.conv1.conv.bias": (64,),
    "PBEnc.conv1.conv.weight": (7, 7, 3, 64),
    "PBEnc.conv2.conv.bias": (128,),
    "PBEnc.conv2.conv.weight": (4, 4, 128, 128),
    "PBEnc.conv3.conv.bias": (256,),
    "PBEnc.conv3.conv.weight": (4, 4, 256, 256),
    "PBEnc.conv4.conv.bias": (512,),
    "PBEnc.conv4.conv.weight": (4, 4, 512, 512),
    "PBEnc.model.1.bias": (256,),
    "PBEnc.model.1.weight": (1, 1, 1024, 256),
    "RGBDec.conv_1.conv.bias": (128,),
    "RGBDec.conv_1.conv.weight": (5, 5, 256, 128),
    "RGBDec.conv_1.norm.beta": (128,),
    "RGBDec.conv_1.norm.gamma": (128,),
    "RGBDec.conv_2.conv.bias": (64,),
    "RGBDec.conv_2.conv.weight": (5, 5, 128, 64),
    "RGBDec.conv_2.norm.beta": (64,),
    "RGBDec.conv_2.norm.gamma": (64,),
    "RGBDec.conv_3.conv.bias": (3,),
    "RGBDec.conv_3.conv.weight": (7, 7, 64, 3),
    "RGBDec.mod_conv_1.bias": (256,),
    "RGBDec.mod_conv_1.weight": (3, 3, 256, 256),
    "RGBDec.mod_conv_2.bias": (256,),
    "RGBDec.mod_conv_2.weight": (3, 3, 256, 256),
    "RGBDec.mod_conv_3.bias": (256,),
    "RGBDec.mod_conv_3.weight": (3, 3, 256, 256),
    "RGBDec.mod_conv_4.bias": (256,),
    "RGBDec.mod_conv_4.weight": (3, 3, 256, 256),
    "RGBDec.mod_conv_5.bias": (256,),
    "RGBDec.mod_conv_5.weight": (3, 3, 256, 256),
    "RGBDec.mod_conv_6.bias": (256,),
    "RGBDec.mod_conv_6.weight": (3, 3, 256, 256),
    "RGBDec.mod_conv_7.bias": (256,),
    "RGBDec.mod_conv_7.weight": (3, 3, 256, 256),
    "RGBDec.mod_conv_8.bias": (256,),
    "RGBDec.mod_conv_8.weight": (3, 3, 256, 256),
    "RGBEnc.model.0.conv.bias": (64,),
    "RGBEnc.model.0.conv.weight": (7, 7, 3, 64),
    "RGBEnc.model.1.conv.bias": (128,),
    "RGBEnc.model.1.conv.weight": (4, 4, 64, 128),
    "RGBEnc.model.2.conv.bias": (256,),
    "RGBEnc.model.2.conv.weight": (4, 4, 128, 256),
    "RGBEnc.model.3.model.0.model.0.conv.bias": (256,),
    "RGBEnc.model.3.model.0.model.0.conv.weight": (3, 3, 256, 256),
    "RGBEnc.model.3.model.0.model.1.conv.bias": (256,),
    "RGBEnc.model.3.model.0.model.1.conv.weight": (3, 3, 256, 256),
    "RGBEnc.model.3.model.1.model.0.conv.bias": (256,),
    "RGBEnc.model.3.model.1.model.0.conv.weight": (3, 3, 256, 256),
    "RGBEnc.model.3.model.1.model.1.conv.bias": (256,),
    "RGBEnc.model.3.model.1.model.1.conv.weight": (3, 3, 256, 256),
    "RGBEnc.model.3.model.2.model.0.conv.bias": (256,),
    "RGBEnc.model.3.model.2.model.0.conv.weight": (3, 3, 256, 256),
    "RGBEnc.model.3.model.2.model.1.conv.bias": (256,),
    "RGBEnc.model.3.model.2.model.1.conv.weight": (3, 3, 256, 256),
    "RGBEnc.model.3.model.3.model.0.conv.bias": (256,),
    "RGBEnc.model.3.model.3.model.0.conv.weight": (3, 3, 256, 256),
    "RGBEnc.model.3.model.3.model.1.conv.bias": (256,),
    "RGBEnc.model.3.model.3.model.1.conv.weight": (3, 3, 256, 256),
    "vgg.0.bias": (64,),
    "vgg.0.weight": (3, 3, 3, 64),
    "vgg.10.bias": (256,),
    "vgg.10.weight": (3, 3, 128, 256),
    "vgg.12.bias": (256,),
    "vgg.12.weight": (3, 3, 256, 256),
    "vgg.14.bias": (256,),
    "vgg.14.weight": (3, 3, 256, 256),
    "vgg.16.bias": (256,),
    "vgg.16.weight": (3, 3, 256, 256),
    "vgg.19.bias": (512,),
    "vgg.19.weight": (3, 3, 256, 512),
    "vgg.2.bias": (64,),
    "vgg.2.weight": (3, 3, 64, 64),
    "vgg.5.bias": (128,),
    "vgg.5.weight": (3, 3, 64, 128),
    "vgg.7.bias": (128,),
    "vgg.7.weight": (3, 3, 128, 128),
}

ALIAS_SHAPES = {
    "RGBDec.Res_Blocks.model.0.model.0.conv.bias": (256,),
    "RGBDec.Res_Blocks.model.0.model.0.conv.weight": (3, 3, 256, 256),
    "RGBDec.Res_Blocks.model.0.model.1.conv.bias": (256,),
    "RGBDec.Res_Blocks.model.0.model.1.conv.weight": (3, 3, 256, 256),
    "RGBDec.Res_Blocks.model.1.model.0.conv.bias": (256,),
    "RGBDec.Res_Blocks.model.1.model.0.conv.weight": (3, 3, 256, 256),
    "RGBDec.Res_Blocks.model.1.model.1.conv.bias": (256,),
    "RGBDec.Res_Blocks.model.1.model.1.conv.weight": (3, 3, 256, 256),
    "RGBDec.Res_Blocks.model.2.model.0.conv.bias": (256,),
    "RGBDec.Res_Blocks.model.2.model.0.conv.weight": (3, 3, 256, 256),
    "RGBDec.Res_Blocks.model.2.model.1.conv.bias": (256,),
    "RGBDec.Res_Blocks.model.2.model.1.conv.weight": (3, 3, 256, 256),
    "RGBDec.conv_1.conv.bias": (128,),
    "RGBDec.conv_1.conv.weight": (5, 5, 256, 128),
    "RGBDec.conv_1.norm.beta": (128,),
    "RGBDec.conv_1.norm.gamma": (128,),
    "RGBDec.conv_2.conv.bias": (64,),
    "RGBDec.conv_2.conv.weight": (5, 5, 128, 64),
    "RGBDec.conv_2.norm.beta": (64,),
    "RGBDec.conv_2.norm.gamma": (64,),
    "RGBDec.conv_3.conv.bias": (3,),
    "RGBDec.conv_3.conv.weight": (7, 7, 64, 3),
    "RGBEnc.model.0.conv.bias": (64,),
    "RGBEnc.model.0.conv.weight": (7, 7, 3, 64),
    "RGBEnc.model.1.conv.bias": (128,),
    "RGBEnc.model.1.conv.weight": (4, 4, 64, 128),
    "RGBEnc.model.2.conv.bias": (256,),
    "RGBEnc.model.2.conv.weight": (4, 4, 128, 256),
    "RGBEnc.model.3.model.0.model.0.conv.bias": (256,),
    "RGBEnc.model.3.model.0.model.0.conv.weight": (3, 3, 256, 256),
    "RGBEnc.model.3.model.0.model.1.conv.bias": (256,),
    "RGBEnc.model.3.model.0.model.1.conv.weight": (3, 3, 256, 256),
    "RGBEnc.model.3.model.1.model.0.conv.bias": (256,),
    "RGBEnc.model.3.model.1.model.0.conv.weight": (3, 3, 256, 256),
    "RGBEnc.model.3.model.1.model.1.conv.bias": (256,),
    "RGBEnc.model.3.model.1.model.1.conv.weight": (3, 3, 256, 256),
    "RGBEnc.model.3.model.2.model.0.conv.bias": (256,),
    "RGBEnc.model.3.model.2.model.0.conv.weight": (3, 3, 256, 256),
    "RGBEnc.model.3.model.2.model.1.conv.bias": (256,),
    "RGBEnc.model.3.model.2.model.1.conv.weight": (3, 3, 256, 256),
}


def random_params(seed: int = 0):
    """(gen_params, alias_params) in the JAX layout, N(0, 0.02) weights (the
    reference's init distribution). For benchmarks and architecture tests;
    real use loads the released checkpoints."""
    rng = np.random.RandomState(seed)
    gen = {k: rng.normal(0.0, 0.02, s).astype(np.float32)
           for k, s in GEN_SHAPES.items()}
    alias = {k: rng.normal(0.0, 0.02, s).astype(np.float32)
             for k, s in ALIAS_SHAPES.items()}
    return gen, alias
