from .decode import (decode_loop, make_prefill_step, make_serve_step,
                     sample_greedy)

__all__ = ["decode_loop", "make_prefill_step", "make_serve_step",
           "sample_greedy"]
