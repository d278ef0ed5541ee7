"""Text encoder adapters (port of rectified_spaattn_tpu/models/encoders.py).

The reference gets its conditioning from the HF pipelines' bundled
encoders (Llama + CLIP for HunyuanVideo, umT5 for Wan).  Here they run
through ``transformers`` on the host (a one-time cost per prompt) from
LOCAL directories only, and their outputs go to ``device`` (default the
card; raises without a GPU unless "cpu").  ``transformers`` is imported
when an encoder first loads, so the package imports without it.  Without
checkpoints, ``HashEncoder`` gives deterministic pseudo-embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device


@dataclasses.dataclass
class HashEncoder:
    """Deterministic prompt -> pseudo-embedding (no weights needed), the
    JAX package's formula: seeded from Python's ``hash`` of the prompt, so
    the embedding is the same within a process (and across processes only
    under one PYTHONHASHSEED)."""
    dim: int
    max_len: int
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def __call__(self, prompt: str, batch: int = 1):
        """(embeddings [batch, max_len, dim] fp32, mask [batch, max_len])."""
        seed = abs(hash(("rsa-tpu", prompt))) % (2 ** 31)
        g = np.random.default_rng(seed)
        n = min(max(len(prompt.split()) + 2, 4), self.max_len)
        emb = np.zeros((batch, self.max_len, self.dim), np.float32)
        emb[:, :n] = g.standard_normal((n, self.dim)).astype(np.float32)
        mask = np.zeros((batch, self.max_len), bool)
        mask[:, :n] = True
        return (torch.from_numpy(emb).to(self.device),
                torch.from_numpy(mask).to(self.device))

    def pooled(self, prompt: str, dim: int, batch: int = 1):
        seed = abs(hash(("rsa-tpu-pool", prompt))) % (2 ** 31)
        g = np.random.default_rng(seed)
        p = np.tile(g.standard_normal((1, dim)).astype(np.float32),
                    (batch, 1))
        return torch.from_numpy(p).to(self.device)


# kind -> the transformers class that holds the encoder alone (None: the
# checkpoint's AutoModel class)
_ENCODER_CLASSES = {"t5": "T5EncoderModel", "umt5": "UMT5EncoderModel",
                    "llama": None, "clip": None}


@dataclasses.dataclass
class TransformersTextEncoder:
    """A local ``transformers`` checkpoint (T5 / umT5 / Llama / CLIP text),
    loaded on first use and run on the host.

    ``model_dir`` holds the weights; ``tokenizer_dir`` the tokenizer
    (default: ``model_dir``; a diffusers snapshot keeps it in its own
    ``tokenizer[_2]/``).  T5 and umT5 run their encoder stack alone."""
    model_dir: str
    max_len: int
    kind: str = "t5"            # t5 | umt5 | llama | clip
    tokenizer_dir: Optional[str] = None
    device: str = "cuda"

    def __post_init__(self):
        if self.kind not in _ENCODER_CLASSES:
            raise ValueError(f"unknown encoder kind {self.kind!r}")
        self.device = resolve_device(self.device)
        self._model = None
        self._tok = None

    def _load(self):
        if self._model is not None:
            return
        import transformers
        self._tok = transformers.AutoTokenizer.from_pretrained(
            self.tokenizer_dir or self.model_dir)
        cls = _ENCODER_CLASSES[self.kind]
        cls = getattr(transformers, cls) if cls else transformers.AutoModel
        self._model = cls.from_pretrained(self.model_dir).eval()

    def _tokens(self, prompt: str, batch: int):
        self._load()
        return self._tok([prompt] * batch, return_tensors="pt",
                         padding="max_length", truncation=True,
                         max_length=self.max_len)

    @torch.no_grad()
    def __call__(self, prompt: str, batch: int = 1):
        """(last hidden states [batch, max_len, dim] fp32 with the padding
        zeroed, mask [batch, max_len]) on ``device``."""
        toks = self._tokens(prompt, batch)
        if self.kind == "clip":
            out = self._model.text_model(**toks).last_hidden_state
        else:
            out = self._model(**toks).last_hidden_state
        mask = toks["attention_mask"].bool()
        emb = out.float() * mask[..., None]
        return emb.to(self.device), mask.to(self.device)

    @torch.no_grad()
    def pooled(self, prompt: str, dim: int = 0, batch: int = 1):
        """CLIP's pooled projection (pooler_output): the pooled prompt
        embedding of HunyuanVideo's conditioning sum."""
        toks = self._tokens(prompt, batch)
        out = self._model.text_model(**toks)
        return out.pooler_output.float().to(self.device)


def make_text_encoder(model_dir: Optional[str], dim: int, max_len: int,
                      kind: str = "t5", device="cuda"):
    """A real encoder when a checkpoint directory is given, else the hash
    encoder."""
    if model_dir:
        return TransformersTextEncoder(model_dir, max_len, kind,
                                       device=device)
    return HashEncoder(dim, max_len, device=device)
