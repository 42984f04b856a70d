"""Actor-side compiled-DAG loop (reference do_exec_tasks,
compiled_dag_node.py:191): attach edge channels, then loop
READ -> COMPUTE -> WRITE until the driver closes the channels.

Edge refs come in two flavors (resolved by the driver's placement pass):
("chan", name)            — same-node: attach the shm channel directly
("rchan", (name, addr))   — cross-node: RemoteChannelReader over the
                            writer process's direct server

Counterpart of `ray_tpu/dag/runtime.py`. A local edge is read zero-copy
(`Channel.read_zc`): the value is parsed straight from the pinned ring
slot, and the slot is released at the end of the iteration. A torch
tensor parsed so would alias the slot and be writable, and a method that
kept it would see the next iteration's bytes in it; so every tensor of a
local edge's value is copied once before the method sees it, and a method
owns what it is given (numpy arrays keep aliasing the slot, as in the JAX
package). This module imports no torch.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List

from ray_tpu_torch.dag.channel import (Channel, ChannelClosedError,
                                       RemoteChannelReader, SlotView)

# device-edge descriptor: the channel carries this tiny dict; the tensor
# stays in the producer's device store (reference
# torch_tensor_accelerator_channel.py: metadata via shm, payload
# out-of-band)
DEVICE_DESC = "__rtpu_device_oid__"


def materialize_channel_value(value):
    """Resolve a channel payload: device descriptors fetch the living
    tensor through the device-object plane (same-process zero-copy, the
    gang's transport between its members, a shm snapshot otherwise). A
    fetch that fails raises (ObjectLostError); nothing falls back."""
    if isinstance(value, dict) and DEVICE_DESC in value:
        import ray_tpu_torch
        from ray_tpu_torch.core.ids import ObjectID
        from ray_tpu_torch.core.object_ref import ObjectRef

        return ray_tpu_torch.get(ObjectRef(ObjectID(value[DEVICE_DESC])))
    return value


def own_tensors(value):
    """`value` with every torch tensor in its dicts, lists and tuples
    replaced by a copy that owns its memory (the rest as it is). Used on
    values parsed from a pinned ring slot, whose tensors alias the slot."""
    torch = sys.modules.get("torch")
    if torch is None:
        return value   # nothing was deserialized as a tensor

    def walk(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        if type(v) in (list, tuple):
            return type(v)(walk(x) for x in v)
        return v

    return walk(value)


def _ref_key(ref) -> tuple:
    kind, val = ref
    if kind == "chan":
        return (kind, val)
    name, addr = val
    return (kind, name, (addr[0], int(addr[1])))


def exec_dag_loop(instance: Any, schedule: List[dict]) -> int:
    from concurrent.futures import ThreadPoolExecutor

    readers: Dict[tuple, Any] = {}
    writers: Dict[str, Channel] = {}
    # overlap scheduling (reference dag_node_operation.py
    # overlap_gpu_communication): reads of channels this actor does NOT
    # produce earlier in the same iteration are issued CONCURRENTLY up
    # front, so a remote edge's RPC latency overlaps other edges' reads
    # and the first steps' compute. Self-produced channels must be read
    # in program order (write-then-read same iteration).
    own_outs = {st["out_chan"] for st in schedule if st["out_chan"]}
    prefetchable = set()
    for st in schedule:
        for ref in list(st["args"]) + list(st["kwargs"].values()):
            if ref[0] in ("chan", "rchan"):
                key = _ref_key(ref)
                name = ref[1] if ref[0] == "chan" else ref[1][0]
                if name not in own_outs:
                    prefetchable.add((key, ref[0], name,
                                      ref[1] if ref[0] == "chan"
                                      else tuple(ref[1][1])))
    pool = (ThreadPoolExecutor(max_workers=min(8, max(1, len(prefetchable))),
                               thread_name_prefix="dag-prefetch")
            if len(prefetchable) > 1 else None)

    def reader(ref) -> Any:
        key = _ref_key(ref)
        if key not in readers:
            if ref[0] == "chan":
                readers[key] = Channel.attach(ref[1])
            else:
                name, addr = ref[1]
                readers[key] = RemoteChannelReader(name, addr)
        return readers[key]

    def writer(name: str) -> Channel:
        if name not in writers:
            writers[name] = Channel.attach(name)
        return writers[name]

    # attach everything up front so the first iteration doesn't race
    # execution (the channels themselves were all created before any loop
    # started — two-phase bring-up in CompiledDAG._start)
    for step in schedule:
        for ref in list(step["args"]) + list(step["kwargs"].values()):
            if ref[0] in ("chan", "rchan"):
                reader(ref)
        if step["out_chan"]:
            writer(step["out_chan"])

    iterations = 0
    # device-edge lifetime: the producer holds the ONLY refs to its
    # device outputs. Ring backpressure bounds reader lag to num_slots
    # values, so num_slots + 2 generations stay alive (the slots a
    # reader may still be fetching plus the value just written) —
    # released as newer writes land.
    from collections import deque as _deque

    dev_refs: Dict[str, "_deque"] = {}
    try:
        while True:
            # one channel may feed several steps in an iteration: read once
            read_cache: Dict[tuple, Any] = {}
            futures = {}
            # local channels are consumed ZERO-COPY (read_zc): the value is
            # parsed from the ring slot, which stays pinned — the writer
            # cannot overwrite it — until the views are released below,
            # AFTER every step of the iteration has run and written its
            # output. Its tensors are copied once (own_tensors), so a step
            # may keep or modify its arguments. Remote edges keep read() —
            # their bytes already crossed an RPC.
            pending_views: List[SlotView] = []
            if pool is not None:
                for key, kind, name, addr in prefetchable:
                    r = reader((kind, name if kind == "chan"
                                else (name, addr)))
                    futures[key] = pool.submit(
                        r.read_zc if isinstance(r, Channel) else r.read)

            def fetch(ref) -> Any:
                key = _ref_key(ref)
                if key not in read_cache:
                    if key in futures:
                        value = futures.pop(key).result()
                    else:
                        r = reader(ref)
                        value = (r.read_zc() if isinstance(r, Channel)
                                 else r.read())
                    if isinstance(value, SlotView):
                        pending_views.append(value)
                        value = own_tensors(value.value())
                    read_cache[key] = materialize_channel_value(value)
                return read_cache[key]

            try:
                for step in schedule:
                    args = [fetch((kind, v)) if kind in ("chan", "rchan")
                            else v
                            for kind, v in step["args"]]
                    kwargs = {k: (fetch((kind, v))
                                  if kind in ("chan", "rchan") else v)
                              for k, (kind, v) in step["kwargs"].items()}
                    result = getattr(instance, step["method"])(*args,
                                                               **kwargs)
                    out = step["out_chan"]
                    if out:
                        if step.get("transport") == "device":
                            from ray_tpu_torch.core.api import _global_client

                            oref = _global_client().put_device(result)
                            gens = dev_refs.setdefault(out, _deque())
                            gens.append(oref)
                            keep = writer(out).num_slots + 2
                            while len(gens) > keep:
                                gens.popleft()   # GC -> dec -> device free
                            result = {DEVICE_DESC: oref.binary()}
                        # same-actor downstream steps re-read the channel
                        # (their ack is counted in num_readers); single-slot
                        # channels support read-after-write in the same
                        # thread because the pinned input views released at
                        # iteration END belong to OTHER channels (a step
                        # reads its own output only after writing it this
                        # iteration)
                        writer(out).write(result)
            finally:
                for sv in pending_views:
                    sv.release()
            iterations += 1
    except ChannelClosedError:
        return iterations
    finally:
        # an input closed (teardown, or an upstream loop that ended) or a
        # step raised: fence this loop's output rings too, so the readers
        # downstream (and the driver) stop waiting once they have drained
        # them; a step's error then reaches the loop's caller
        for ch in writers.values():
            ch.shutdown()
        dev_refs.clear()   # release held device outputs
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
