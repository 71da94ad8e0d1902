"""Distributed pieces of the port.

Ported: serving across a (data, model) mesh, tensor-parallel dense layers
and expert-parallel MoE, data-parallel slots (``sharding``: the
reference's rules, ``AxisPlan``, ``plan_scope``, ``shard_params``;
``collectives``: all-reduce and all-gather over an axis's process group,
with the backward rules that SPMD semantics give them; the mesh and the
ranks' process groups in ``launch/mesh.py``); training the dense family
under a mesh, FSDP (ZeRO-3) over the data axis included
(``sharding.shard_train_state`` / ``gather_train_state``,
``training.train_loop``); and the int8 gradient compression with error
feedback (``compression``), a group compressed whole under a mesh. Not
ported (ROADMAP.md queue 1 item 9 steps 3 onward): MoE training under a
mesh (the reference's ``_moe_mlp_shardmap``), sequence parallelism
(``collectives.sp_scatter`` / ``sp_gather`` are no-ops without a ``seq``
axis), pipeline stages, elastic re-meshing, and the SSM, hybrid, VLM and
audio families under a mesh."""
