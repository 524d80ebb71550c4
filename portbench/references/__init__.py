"""Plain references, one module a family of configurations.

A configuration's ``reference`` key names its module here,
``references/<name>.py``. The module imports nothing of the program, of JAX
or of the JAX package, and takes nothing the program made. It gives:

* ``palette(frame0, config, device)``: the (P, 3) integer palette worked
  out again from the first frame;
* ``palette_checks(frame0, port_palette, ref_palette, config)``: numbers
  compared about the program's palette, by name;
* ``outputs(frames, palette, config, device, dtype)``: the (N, H, W, 3)
  uint8 outputs of the configuration on (N, H, W, 3) uint8 frames;
* ``scan_work(config, frames, h, w, input_bytes)``: the operations, bytes
  and least time of one launch of the kernel the configuration runs most
  (``roofline.scan_work``'s keys), or None where it has none.
"""
