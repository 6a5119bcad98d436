"""Plain references the benchmark judges the program's outputs by. A
configuration's ``reference`` key names the module here that computes its
model (``harness.reference_module``); ``common`` holds what every reference
and the check share. Nothing here imports the program.

A reference module provides:

- ``Reference(model, params, *, low=None)``: the model of the
  configuration's ``model`` block over the benchmark's weights, in float32,
  or with ``low`` (``common.fp8``) as the control. Its
  ``context_kv(tokens)`` computes a context's state from its (S,) tokens:
  a tuple (k, v, *rest), k and v each (len(kv_layers), S, hkv, hd), rows
  in ``kv_layers`` order; ``rest`` is whatever else the model carries
  past the context (a recurrent layer's state). Its ``decode(state,
  tokens)`` feeds (T,) tokens one after the other after such a state and
  returns their (T, vocab) logits and the (k, v) they add, each
  (len(kv_layers), T, hkv, hd). The check hands ``decode`` the state
  ``context_kv`` gave, with k and v of the streamed chunks quantized and
  ``rest`` untouched.
- ``kv_layers(model)``: the model's layers that hold K and V, in the order
  of the program's stored rows.
- ``step_flops(model, kv_len)``: the model operations of one decode step.
"""
