"""The neural pixelizer: C2PGen, AliasNet and the VGG19 feature taps
(``c2pgen.py``) over the layers of ``layers.py``, its weights
(``param_shapes.py``, ``convert.py``) and its serving surface
(``inference.py``, ``pixelizer.py``). NCHW tensors; the modules' state-dict
keys and layouts are the reference checkpoints' own."""
