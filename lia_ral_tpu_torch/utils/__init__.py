"""Host-side helpers of the port."""

from .shapes import FRAME_BUCKET, bucket_len, next_pow2

__all__ = ["FRAME_BUCKET", "bucket_len", "next_pow2"]
