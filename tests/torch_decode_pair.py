"""One small flagship captioner in both packages, for the port's decode
tests (speculative, continuous, sampling).

JAX's TransformerFlattened is initialised with PRNGKey(0) and carried
into the port by `params_from_jax`; requests are drawn with numpy from a
seed and handed to both as arrays. `eos_bias` leans the eos word row
toward the mean decoder state, so that some captions end before max_len.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from news_image_caption_tpu.models.captioner import \
    TransformerFlattened as JaxTransformerFlattened
from news_image_caption_tpu.models.decoder_flattened import \
    DynamicConvDecoder as JaxDecoder
from news_image_caption_tpu_torch.models.captioner import TransformerFlattened
from news_image_caption_tpu_torch.models.from_jax import params_from_jax

V, D, FFN, H = 120, 32, 64, 4
CUTOFF = (40, 80, V)
IMG_DIM, ART_DIM = 48, 32
P, S = 5, 7


def small(kernels):
    return dict(vocab_size=V, cutoff=CUTOFF, embed_dim=D, ffn_dim=FFN,
                num_heads=H, num_layers=len(kernels), kernel_sizes=kernels,
                image_dim=IMG_DIM, article_dim=ART_DIM, max_positions=64)


def request_arrays(B, seed, article_len=S):
    """A batch of B requests' contexts as numpy arrays."""
    rng = np.random.RandomState(seed)
    mask = np.zeros((B, article_len), bool)
    mask[B // 2:, article_len - 2:] = True
    return {"image": rng.randn(B, P, IMG_DIM).astype(np.float32),
            "image_mask": np.zeros((B, P), bool),
            "article": rng.randn(B, article_len, ART_DIM).astype(np.float32),
            "article_mask": mask}


def jax_batch(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


def torch_batch(arrays):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}


def make_pair(kernels, eos_bias=0.0, seed=0):
    """(JAX model, its params, the port's model with the same weights)."""
    arrays = request_arrays(3, seed)
    rng = np.random.RandomState(seed + 1)
    caption = rng.randint(2, V, size=(3, 10)).astype(np.int32)
    caption[:, 0] = 0
    jbatch = {"caption_ids": jnp.asarray(caption), **jax_batch(arrays)}
    jmodel = JaxTransformerFlattened(**small(kernels))
    params = jax.tree.map(lambda a: a, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jbatch))
    if eos_bias:
        hidden = jax.jit(lambda p, b: jmodel.decoder.apply(
            p, b["caption_ids"], jmodel._contexts(b),
            method=JaxDecoder.hidden))
        h = np.asarray(hidden(params, jbatch)).reshape(-1, D)
        m = h.mean(0)
        adaptive = params["params"]["embedder"]["adaptive"]
        e0 = np.array(adaptive["embed_0"])
        e0[2] += eos_bias * m / (m @ m)
        adaptive["embed_0"] = jnp.asarray(e0)
    model = TransformerFlattened(device="cpu", dtype=torch.float32,
                                 **small(kernels))
    model.decoder.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, params), model.decoder))
    model.decoder.eval()
    return jmodel, params, model
