"""The LM side's sharding (twin of ``repro.distributed``'s one-process half):
`ctx` lets model code place activation constraints, `sharding` gives every
parameter, cache and input its spec on a mesh and turns a spec into DTensor
placements. The collectives over processes are ROADMAP item 16d."""
