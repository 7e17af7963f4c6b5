"""Hand-written Hopper (sm_90a) kernels for the serving path and its wire.

``csrc/<name>.cu`` holds each CUDA kernel behind a plain C interface;
``build.py`` compiles them with nvcc on first use and counts launches;
``<name>.py`` holds each kernel's PyTorch wrapper (the kernel on a CUDA
tensor, the plain version on a CPU tensor); ``ops.py`` the model-layout
wrappers; ``ref.py`` the plain PyTorch versions.

Kernels (each replaces the Pallas TPU kernel of the same name in the JAX
package):
* flash_attention — blocked online-softmax GQA attention (prefill)
* decode_attention — flash-decode against full or ring KV caches
* digest — lattice digest for accelerator-placed integrity: per row, and
  whole items or slabs to their fingerprints in one launch
* ssd_scan — chunked Mamba2 SSD scan (prefill), returning the final state
* quantize — blockwise int8 quantize / dequantize for the compressed wire,
  a slab of items in one launch
"""
