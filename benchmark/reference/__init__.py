"""The benchmark's plain reference: what the served and trained paths
compute, written out again in plain float32 PyTorch (TF32 off) and NumPy.

Nothing here imports JAX, the JAX package or the port; nothing here takes
anything the port made.  Given the same audio, labels, weights and dropout
seeds as the port, it works out the CQT features, the model's logits, the
smoothed loss, the gradients and the optimizer's updates by itself.

- :mod:`.cqt`: the constant-Q filterbank and transform, framing, the bicubic
  resize and the input normalizations;
- :mod:`.models`: the model of a configuration's arch, from ``arch_<arch>.py``
  (:mod:`.arch_resnet18`: GuitarTabNet, a ResNet-18 trunk and six branch
  heads; :mod:`.arch_vit_s8`: ViTTab, ViT-S/8, fc1/fc2, six heads), with the
  reference checkpoints' key layout;
- :mod:`.train`: label-smoothed loss, clipped Adam/AdamW, three train steps;
- :mod:`.precision`: the float32 arithmetic and the one-step-lower control
  (fp8 e4m3 operands in the backbone's products).
"""
