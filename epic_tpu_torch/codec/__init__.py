from .container import dump_bitstreams, load_bitstreams
from .pic_codec import PICCodec
from .pipeline import SweepPipeline, run_sweeps
from .progressive import (DEFAULT_Q_LIST, progressive_decode,
                          progressive_decode_all, progressive_encode,
                          progressive_encode_finish, progressive_encode_start)

__all__ = ["DEFAULT_Q_LIST", "PICCodec", "SweepPipeline", "dump_bitstreams",
           "load_bitstreams", "progressive_decode", "progressive_decode_all",
           "progressive_encode", "progressive_encode_finish",
           "progressive_encode_start", "run_sweeps"]
