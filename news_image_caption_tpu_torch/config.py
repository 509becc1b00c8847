"""Model configurations of the port, as plain dicts.

`FLAGSHIP` is the decoder of `configs/goodnews_transformer_roberta.yaml`
(the Transform-and-Tell captioner the reference serves), written out so
the port needs no YAML reader. `FLAGSHIP_TRAIN` and
`FLAGSHIP_OPTIMIZER` are the same file's training settings: the
decoder's dropouts and flash switch, `iterator.batch_size`,
`dataset.caption_len` and `trainer.optimizer` (BertAdam); its
`trainer.mixed_precision` is bf16_o2.
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

# Training settings of the same file.
FLAGSHIP_TRAIN = dict(
    dropout=0.1,
    weight_dropout=0.1,
    relu_dropout=0.0,
    input_dropout=0.1,
    attention_dropout=0.1,
    use_flash_train=True,
)
FLAGSHIP_OPTIMIZER = dict(
    lr=1e-4,
    warmup=0.05,
    t_total=437600,
    b1=0.9,
    b2=0.98,
    eps=1e-6,
    weight_decay=1e-5,
    max_grad_norm=0.1,
)
FLAGSHIP_BATCH_SIZE = 16
FLAGSHIP_CAPTION_LEN = 64
