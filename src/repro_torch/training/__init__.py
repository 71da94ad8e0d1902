"""Training of the port: the paper's QAT forward (``core.quantize.fake_quant``
in ``models.layers.lut_dense`` and the MoE experts), optimizers, the train
step with microbatch accumulation and int8 gradient compression, data
streams, checkpoint/restart and the fault-tolerance policy. The
counterparts of the reference's ``training/`` modules, on the port's param
trees (dicts and lists of layer dicts holding tensors)."""
