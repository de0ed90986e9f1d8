"""The paper's fused-layer dataflow on a row-sharded (or sequence-sharded)
tensor: ``tiling`` (the receptive-field rows of a fused group), ``halo``
(one halo exchange per fused ResNet group) and ``seq_halo`` (the same halo
for sliding-window attention)."""
