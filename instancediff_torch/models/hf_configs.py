"""HF text-tower architecture registry (port of
``instancediff_tpu/models/hf_configs.py``, its table copied): ``ARCH_DICT``
maps an HF ``model_type`` to the config field names that hold the tower's
dimensions, its default pooler, its position offset and the encoder family;
``resolve_hf_text_cfg`` reads a config through it and
``build_hf_text_tower`` builds the tower. The bert, roberta and xlm-roberta
families are post-LN BERT encoders (``text_encoder.HFContextTextEncoder``;
their HF weights convert through ``load_torch_bert_weights``); mt5 and
m2m_100 resolve but have no tower here and raise with the resolved
dimensions, as in JAX.
"""

from __future__ import annotations

ARCH_DICT = {
    "roberta": {
        "config_names": {
            "context_length": "max_position_embeddings",
            "vocab_size": "vocab_size",
            "width": "hidden_size",
            "heads": "num_attention_heads",
            "layers": "num_hidden_layers",
            "layer_attr": "layer",
            "token_embeddings_attr": "embeddings",
        },
        "pooler": "mean_pooler",
        # RobertaEmbeddings offsets positions by padding_idx+1 (HF
        # create_position_ids_from_input_ids): valid token i reads row i+2
        "position_offset": 2,
        "encoder": "post_ln_bert",
    },
    "xlm-roberta": {
        "config_names": {
            "context_length": "max_position_embeddings",
            "vocab_size": "vocab_size",
            "width": "hidden_size",
            "heads": "num_attention_heads",
            "layers": "num_hidden_layers",
            "layer_attr": "layer",
            "token_embeddings_attr": "embeddings",
        },
        "pooler": "mean_pooler",
        "position_offset": 2,
        "encoder": "post_ln_bert",
    },
    "mt5": {
        "config_names": {
            "context_length": "",  # unlimited seqlen (relative attention)
            "vocab_size": "vocab_size",
            "width": "d_model",
            "heads": "num_heads",
            "layers": "num_layers",
            "layer_attr": "block",
            "token_embeddings_attr": "embed_tokens",
        },
        "pooler": "mean_pooler",
        "position_offset": 0,
        "encoder": None,  # T5 encoder-decoder; not a BERT-family tower
    },
    "bert": {
        "config_names": {
            "context_length": "max_position_embeddings",
            "vocab_size": "vocab_size",
            "width": "hidden_size",
            "heads": "num_attention_heads",
            "layers": "num_hidden_layers",
        },
        "pooler": "cls_pooler",
        "position_offset": 0,
        "encoder": "post_ln_bert",
    },
    "m2m_100": {
        "config_names": {
            "context_length": "max_position_embeddings",
            "vocab_size": "vocab_size",
            "width": "d_model",
            "heads": "encoder_attention_heads",
            "layers": "encoder_layers",
        },
        "pooler": "cls_pooler",
        "position_offset": 0,
        "encoder": None,  # seq2seq encoder with sinusoidal positions
    },
}


def resolve_hf_text_cfg(config) -> dict:
    """Resolve tower dimensions from an HF config (a transformers
    ``PretrainedConfig`` or a plain dict with ``model_type``) through the
    arch registry's field names. Returns
    ``{model_type, context_length, vocab_size, width, heads, layers,
    pooler, position_offset, encoder}`` (``context_length`` None for
    unlimited-seqlen archs like mt5)."""
    get = (config.get if isinstance(config, dict)
           else lambda k, d=None: getattr(config, k, d))
    model_type = get("model_type")
    if model_type not in ARCH_DICT:
        raise KeyError(
            f"unknown HF arch {model_type!r}; known: {sorted(ARCH_DICT)}")
    arch = ARCH_DICT[model_type]
    names = arch["config_names"]
    out = {"model_type": model_type,
           "pooler": arch["pooler"],
           "position_offset": arch["position_offset"],
           "encoder": arch["encoder"]}
    for field in ("context_length", "vocab_size", "width", "heads", "layers"):
        name = names.get(field, "")
        out[field] = get(name) if name else None
    return out


def build_hf_text_tower(config, proj_dim: int = 512, pooler_type: str | None = None,
                        context_length: int | None = None):
    """An ``HFContextTextEncoder`` for an HF config of the post-LN BERT
    family (bert / roberta / xlm-roberta) with the arch's dimensions,
    default pooler (or ``pooler_type``), position offset and
    ``layer_norm_eps`` (1e-12 when the config has none); its context length
    is ``context_length`` or the config's (256 for an unlimited one), capped
    at the position table. Returns (tower, resolved cfg). Raises
    NotImplementedError with the resolved cfg for another family."""
    from .text_encoder import HFContextTextEncoder

    cfg = resolve_hf_text_cfg(config)
    if cfg["encoder"] != "post_ln_bert":
        raise NotImplementedError(
            f"HF arch {cfg['model_type']!r} resolved to {cfg} but only the post-LN BERT "
            "family has a tower here (the reference builds these via transformers.AutoModel)")
    get = (config.get if isinstance(config, dict)
           else lambda k, d=None: getattr(config, k, d))
    ctx = context_length or cfg["context_length"] or 256
    tower = HFContextTextEncoder(
        context_length=min(ctx, cfg["context_length"] or ctx),
        vocab_size=cfg["vocab_size"],
        hidden=cfg["width"],
        heads=cfg["heads"],
        layers=cfg["layers"],
        proj_dim=proj_dim,
        max_position=cfg["context_length"] or 512,
        pooler_type=pooler_type or cfg["pooler"],
        position_offset=cfg["position_offset"],
        ln_eps=get("layer_norm_eps", None) or 1e-12,
    )
    return tower, cfg
