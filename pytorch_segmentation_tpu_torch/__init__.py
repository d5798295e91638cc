"""PyTorch and CUDA port of pytorch_segmentation_tpu, for NVIDIA Hopper.

The JAX package beside it is the reference the port is held against. This
package imports torch and never jax or flax.
"""
