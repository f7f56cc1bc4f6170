"""Quantization: the static ``QuantConfig`` and the ``QuantizedTensor``
with its golden quantize/dequantize, byte-identical with the JAX
package's."""
