from .mt19937 import MT19937
from .bits import bytes_to_bits, bits_to_bytes, jnp_bits_to_bytes_array, jnp_bytes_to_bits
from .device import resolve_device

__all__ = [
    "MT19937",
    "bytes_to_bits",
    "bits_to_bytes",
    "jnp_bits_to_bytes_array",
    "jnp_bytes_to_bits",
    "resolve_device",
]
