"""vitvs_tpu_torch — the PyTorch/CUDA port of ``vitvs_tpu`` for NVIDIA Hopper.

The DINO servo step runs here as eager PyTorch on the card:

    camera frame -> preprocess (two f32 resize matmuls + normalize)
                 -> DINOv2-style ViT facet forward (attention: csrc/attention.cu;
                    the int8 serving step: csrc/attention_fast.cu, csrc/attn_int8.cu)
                 -> log-binned patch descriptors
                 -> cosine mutual-argmax matching (csrc/matcher.cu, bf16 mode
                    on the tensor cores by default)
                    + cyclical consistency + fixed-k sampling
                 -> IBVS control law -> body twist

Module names mirror ``vitvs_tpu`` so each counterpart is easy to find.  The
package imports neither JAX nor ``vitvs_tpu``; the CUDA kernels are built at
first use by ``ops/_build.py`` (one ``nvcc`` per source, loaded with ``ctypes``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``, where
every kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"
