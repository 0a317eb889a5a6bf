"""One module per engine kind named in a config file's `engine.kind`:
`build(lm, cfg)` makes the port's engine, `prefill_call(engine, args)`
reads (pos0, real rows, padded rows) from the arguments of the prefill
function that `PREFILL` names, and `DECODE_ATTENTION_GROUP` names the
kernel group that runs decode attention (None: plain ops, no group)."""
