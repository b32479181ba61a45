from .ldpc_matrix import BLOCK_BITS, CODE_PARAMS, RATE_ENUM, RECOMMENDED_ITERS, get_code, encode_np
from .ldpc import (DecodeResult, LDPCCodec, LDPCDecoder, candidate_plan, decode_batch,
                   decode_candidates, decode_chunked, decode_with_retries, make_decoder,
                   make_decoder_vf, make_encoder, make_tile_decoder)
from .ldpc_cuda import make_cuda_decoder, make_cuda_decoder_v1

__all__ = [
    "BLOCK_BITS",
    "CODE_PARAMS",
    "RATE_ENUM",
    "RECOMMENDED_ITERS",
    "get_code",
    "encode_np",
    "LDPCCodec",
    "make_decoder",
    "make_encoder",
    "DecodeResult",
    # the port's own
    "LDPCDecoder",
    "candidate_plan",
    "decode_batch",
    "decode_candidates",
    "decode_chunked",
    "decode_with_retries",
    "make_decoder_vf",
    "make_tile_decoder",
    "make_cuda_decoder",
    "make_cuda_decoder_v1",
]
