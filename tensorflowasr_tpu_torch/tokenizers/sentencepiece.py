"""SentencePiece tokenizer (counterpart of ``tensorflowasr_tpu/tokenizers/sentencepiece.py``).

``make`` loads a trained SentencePiece ``.model`` through the pure-Python
codec in ``spm.py`` (unigram Viterbi and BPE merges), so published
vocabularies give the published token ids. ``build`` trains with the HF
``tokenizers`` unigram or BPE trainer and writes both a ``.model``
protobuf and the HF ``.json``; only ``build`` and loading a ``.json``
import HF ``tokenizers``.
"""

from __future__ import annotations

import os

import numpy as np

from tensorflowasr_tpu_torch.configs import DecoderConfig
from tensorflowasr_tpu_torch.tokenizers import spm
from tensorflowasr_tpu_torch.tokenizers.base import Tokenizer
from tensorflowasr_tpu_torch.utils import file_util

PAD = "<pad>"  # blank == pad == 0, as in the reference sentencepiece setup
UNK = "<unk>"


class SentencePieceTokenizer(Tokenizer):
    def __init__(self, decoder_config: DecoderConfig):
        super().__init__(decoder_config)
        self._hf = None  # an HF tokenizers.Tokenizer, when made from a .json
        self._spm: spm.SentencePieceModel | None = None

    def _model_path(self) -> str:
        path = self.decoder_config.vocabulary or ""
        if not path.endswith(".model"):
            path = os.path.splitext(path)[0] + ".model" if path else path
        return file_util.preprocess_paths(path)

    def _json_path(self) -> str:
        path = self.decoder_config.vocabulary or ""
        stem = path[: -len(".model")] if path.endswith(".model") else os.path.splitext(path)[0]
        return file_util.preprocess_paths(stem + ".json")

    def make(self):
        model_path, json_path = self._model_path(), self._json_path()
        if model_path and os.path.exists(model_path):
            self._spm = spm.SentencePieceModel.load(model_path)
            self.num_classes = len(self._spm.pieces)
            self.tokens = list(self._spm.pieces)
        elif json_path and os.path.exists(json_path):
            from tokenizers import Tokenizer as HFTokenizer

            self._hf = HFTokenizer.from_file(json_path)
            vocab = self._hf.get_vocab()
            self.num_classes = len(vocab)
            self.tokens = [""] * self.num_classes
            for tok, idx in vocab.items():
                self.tokens[idx] = tok
        else:
            raise FileNotFoundError(f"sentencepiece model not found: {model_path or json_path} — run build() first")
        self.blank = self.decoder_config.blank_index
        self.initialized = True

    def build(self, *datasets):
        from tokenizers import Tokenizer as HFTokenizer
        from tokenizers import decoders, models, pre_tokenizers, trainers

        model_type = (self.decoder_config.model_type or "unigram").lower()
        if model_type == "bpe":
            hf = HFTokenizer(models.BPE(unk_token=UNK))
            trainer = trainers.BpeTrainer(
                vocab_size=self.decoder_config.vocab_size,
                special_tokens=[PAD, UNK],
                show_progress=False,
            )
        else:
            hf = HFTokenizer(models.Unigram())
            trainer = trainers.UnigramTrainer(
                vocab_size=self.decoder_config.vocab_size,
                special_tokens=[PAD, UNK],
                unk_token=UNK,
                max_piece_length=self.decoder_config.max_sentencepiece_length,
                n_sub_iterations=max(2, self.decoder_config.num_iterations),
                show_progress=False,
            )
        hf.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="first")
        hf.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="first")
        hf.train_from_iterator(self.generator(*datasets), trainer=trainer)
        json_path = self._json_path()
        if json_path:
            hf.save(json_path)
        # export a real sentencepiece ModelProto so the configured .model
        # path works verbatim (and stock sentencepiece can read our vocab)
        self._spm = _hf_to_spm(hf, model_type)
        model_path = self._model_path()
        if model_path:
            self._spm.save(model_path)
        self._hf = None
        self.num_classes = len(self._spm.pieces)
        self.tokens = list(self._spm.pieces)
        self.blank = self.decoder_config.blank_index
        self.initialized = True

    def tokenize(self, text: str) -> np.ndarray:
        text = self.normalize_text(text, self.decoder_config)
        if self._spm is not None:
            ids = self._spm.encode(text)
        else:
            ids = self._hf.encode(text).ids
        return np.asarray(ids, np.int32)

    def detokenize(self, indices) -> str:
        indices = self.normalize_indices(indices)
        ids = [int(i) for i in np.asarray(indices).reshape(-1) if int(i) != self.blank]
        if self._spm is not None:
            text = self._spm.decode(ids)
        else:
            text = self._hf.decode(ids, skip_special_tokens=True)
        return text.strip()

    def _token_text_for_upoints(self, index: int) -> str:
        if self._spm is not None:
            t = self._spm.types[index]
            if t not in (spm.NORMAL, spm.USER_DEFINED):
                return ""
            return self._spm.pieces[index].replace("▁", " ")
        tok = self.tokens[index]
        if tok in (PAD, UNK):
            return ""
        return tok.replace("▁", " ")


def _hf_to_spm(hf, model_type: str) -> spm.SentencePieceModel:
    """Convert a trained HF tokenizer into a SentencePiece ModelProto model."""
    import json

    state = json.loads(hf.to_str())
    if model_type == "bpe":
        vocab_map = state["model"]["vocab"]  # {piece: id}
        merges = state["model"]["merges"]  # list of [a, b] (or "a b")
        pieces = [""] * len(vocab_map)
        for p, i in vocab_map.items():
            pieces[i] = p
        # sentencepiece BPE scores are -merge_rank; merged pieces get their
        # merge order, everything else (chars/specials) sorts below merges
        scores = [0.0] * len(pieces)
        merged_rank: dict[str, int] = {}
        for rank, m in enumerate(merges):
            a, b = (m if isinstance(m, (list, tuple)) else m.split(" ", 1))
            merged_rank.setdefault(a + b, rank)
        base = len(merges)
        k = 0
        for i, p in enumerate(pieces):
            if p in merged_rank:
                scores[i] = -float(merged_rank[p])
            else:
                scores[i] = -float(base + k)
                k += 1
        mtype = spm.BPE
    else:
        vocab = state["model"]["vocab"]  # list of [piece, score]
        pieces = [p for p, _ in vocab]
        scores = [float(s) for _, s in vocab]
        mtype = spm.UNIGRAM
    types = []
    unk_id = 0
    for i, p in enumerate(pieces):
        if p == UNK:
            types.append(spm.UNKNOWN)
            unk_id = i
        elif p == PAD:
            types.append(spm.CONTROL)
        else:
            types.append(spm.NORMAL)
    return spm.SentencePieceModel(
        pieces=pieces,
        scores=scores,
        types=types,
        model_type=mtype,
        unk_id=unk_id,
        unk_surface="",  # reference trains with unk_surface="" (tokenizers.py:291)
    )
