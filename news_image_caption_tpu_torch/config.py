"""Model configurations of the port, as plain dicts.

`FLAGSHIP` is the decoder of `configs/goodnews_transformer_roberta.yaml`
(the Transform-and-Tell captioner the reference serves), written out so
the port needs no YAML reader.
"""

FLAGSHIP = dict(
    vocab_size=50265,
    cutoff=(5000, 20000, 50265),
    embed_dim=1024,
    ffn_dim=4096,
    num_heads=16,
    num_layers=4,
    kernel_sizes=(3, 7, 15, 31),
    image_dim=2048,
    article_dim=1024,
    padding_idx=0,
    target_padding_idx=1,
    max_positions=512,
)

# Serving shapes of the flagship: image patches and article tokens.
FLAGSHIP_IMAGE_LEN = 49
FLAGSHIP_ARTICLE_LEN = 512
