"""Plain PyTorch reference of the benchmark's models.

Written from the models' equations and the configurations, in float32
(float64 for the operator and the Lanczos recursion) with TF32 off. It
imports nothing of the program, and works out the operator, the Ritz
pairs, the logits, the loss, the gradients and Adam's update from the
graph and the weights that the benchmark hands to both sides.

``Precision`` says where the 16-bit and the float32 products of the
program's dtype contract round: not at all in the reference; to fp8
(e4m3) and to TF32's 10-bit mantissa in the control, the reference put
in the program's place one precision lower.
"""
