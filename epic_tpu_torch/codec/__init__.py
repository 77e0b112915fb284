from .pic_codec import PICCodec
from .progressive import (DEFAULT_Q_LIST, progressive_decode,
                          progressive_decode_all, progressive_encode)

__all__ = ["DEFAULT_Q_LIST", "PICCodec", "progressive_decode",
           "progressive_decode_all", "progressive_encode"]
