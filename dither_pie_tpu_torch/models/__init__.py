"""The neural pixelizer: C2PGen, AliasNet and the VGG19 feature taps
(``c2pgen.py``) over the layers of ``layers.py``, its weights
(``param_shapes.py``, ``convert.py``) and its serving surface
(``inference.py``, ``pixelizer.py``); the GAN trainer's nets, P2CGen
(``p2cgen.py``) and CPDis with its spectral norm (``discriminator.py``),
its losses (``losses.py``) and its step, schedules and checkpoints
(``training.py``). NCHW tensors; the modules' state-dict keys and layouts
are the reference checkpoints' own (the JAX package's, for the trainer's
nets)."""
