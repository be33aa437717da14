"""The benchmark's plain reference H.261 encoder, frozen.

A copy of the port's plain CPU path (spec tables, layout, DCT, quantizer,
loop filter, prediction, reconstruction, mode decisions, rate control,
bit model, the dense SAD map) with every CUDA dispatch removed, plus a
vectorized serializer (`serialize`) and a decoder of damaged streams: a
plain parse that scans for start codes (`parse`) and the reconstruction of
what it keeps (`playback`).  It imports nothing of `jax`, of the JAX
package or of the port, and takes nothing the port made: the benchmark
hands it the same raw frames, or the same damaged bytes, it hands the
port.  Every function runs on whatever device its tensors are on, as
plain torch operations.

The DCT and IDCT compute in float64, exactly as the port's do
(`dct.precision` lowers them for the benchmark's control).
"""
