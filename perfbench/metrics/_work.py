"""The operations and bytes a served step needs, counted from the model's
sizes and from the nonzeros of the pruned matrices (worked out by the
reference from the weights the harness made), never from the program's
packs: a narrower index plane or less padding raises a share, it does not
move the yardstick.

Conventions (one layer, n tokens):

- a projection streams its weights once: a dense one at 2 bytes a weight
  (bf16); an ESPIM one at its value code's bytes a nonzero (1 for int8)
  and a column index local to its chunk (2 bytes for chunks of 257 to
  65536 columns, 1 for narrower) plus the code's scale bytes per scale
  group of output rows (4 per 128 for int8);
- it reads its input and writes its output once, 2 bytes an element (bf16
  activations): gate and up write their GLU product, d_ff a token;
- it does 2 operations a weight it uses (nonzero or dense) a token;
- attention at a context of c positions reads c - 1 cached K and V rows and
  writes the new one (2 bytes an element, ``kv_heads * head_dim`` a row)
  and does 4 * c * heads * head_dim operations a token;
- the tied lm_head streams vocab x d bf16 weights once and does 2 * vocab
  * d operations a token whose logits are needed, writing them at 2 bytes;
  the embedding reads d bf16 values a token.

A decode tick needs the logits of every decoding token; a prefill needs
the logits of the prompt's last token only, reads the weights once for
the whole prompt and attends causally up to each position.
"""
from __future__ import annotations

import dataclasses

__all__ = ["WorkModel", "bound_seconds", "index_bytes"]

ACT_BYTES = 2          # bf16 activations, K/V, logits, dense weights


def index_bytes(chunk_cols: int) -> int:
    """Bytes of a column index local to a chunk of ``chunk_cols``."""
    return 1 if chunk_cols <= 256 else 2 if chunk_cols <= 65536 else 4


def bound_seconds(flops: float, nbytes: float, peaks: dict) -> float:
    """The least time the chip could take: the larger of the operations
    at the bf16 tensor peak and the bytes at the memory bandwidth."""
    return max(flops / peaks["bf16_flops"], nbytes / peaks["bytes_per_s"])


@dataclasses.dataclass
class WorkModel:
    layers: int
    d: int
    heads: int
    kv_heads: int
    hd: int
    vocab: int
    shapes: dict           # group -> (projections, input width, output
                           # width, rows), the family's ``group_shapes``
    weights: dict          # projection -> [weights used, one per layer]
    codes: dict | None = None   # ESPIM planes: {"value", "index",
                                # "scale" bytes, "scale_rows"}; None: dense

    @property
    def sparse(self) -> bool:
        return self.codes is not None

    def group_weights(self, group: str, layer: int) -> int:
        return sum(self.weights[p][layer] for p in self.shapes[group][0])

    def group_bytes(self, group: str, layer: int, n: int) -> int:
        """One group's bytes in one layer for n tokens: weights (and
        scales) once, input and output once a token."""
        _projs, d_in, d_out, rows = self.shapes[group]
        w = self.group_weights(group, layer)
        if self.sparse:
            c = self.codes
            wb = (w * (c["value"] + c["index"])
                  + c["scale"] * -(-rows // c["scale_rows"]))
        else:
            wb = w * ACT_BYTES
        return wb + ACT_BYTES * n * (d_in + d_out)

    def projections(self, n: int) -> tuple:
        """(operations, bytes) of every layer's projections for n
        tokens."""
        flops = nbytes = 0
        for l in range(self.layers):
            for g in self.shapes:
                flops += 2 * n * self.group_weights(g, l)
                nbytes += self.group_bytes(g, l, n)
        return flops, nbytes

    def spmv_bytes(self, n: int) -> int:
        """Bytes of one decode tick's SpMV launches (every group of every
        layer) for n decoding tokens."""
        return sum(self.group_bytes(g, l, n) for l in range(self.layers)
                   for g in self.shapes)

    def _kv_row(self) -> int:
        return 2 * self.kv_heads * self.hd * ACT_BYTES     # K and V

    def _attn_flops(self, context: int) -> int:
        return 4 * context * self.heads * self.hd * self.layers

    def decode_tick(self, contexts) -> tuple:
        """(operations, bytes) of one decode tick; ``contexts``: each
        decoding token's attended positions."""
        n = len(contexts)
        flops, nbytes = self.projections(n)
        flops += 2 * n * self.vocab * self.d
        nbytes += self.vocab * self.d * ACT_BYTES          # lm_head
        nbytes += n * self.vocab * ACT_BYTES               # logits
        nbytes += n * self.d * ACT_BYTES                   # embedding rows
        for c in contexts:
            flops += self._attn_flops(c)
            nbytes += c * self._kv_row() * self.layers
        return flops, nbytes

    def prefill(self, prompt_len: int) -> tuple:
        """(operations, bytes) of one prompt's whole prefill."""
        p = prompt_len
        flops, nbytes = self.projections(p)
        flops += 2 * self.vocab * self.d                   # last token
        nbytes += self.vocab * self.d * ACT_BYTES + self.vocab * ACT_BYTES
        nbytes += p * self.d * ACT_BYTES
        flops += 4 * (p * (p + 1) // 2) * self.heads * self.hd * self.layers
        nbytes += p * self._kv_row() * self.layers          # K/V written
        return flops, nbytes
