"""Multi-pod localized caching: rendezvous-hashed pod-local cache shards,
pod-affinity routing, and failover when a pod dies (the counterpart of
``examples/multi_pod_cache.py``; it prints the same lines).

    PYTHONPATH=src python -m repro_torch.launch.multi_pod_cache
"""
import json

from repro_torch.agent.geollm.datastore import GeoDataStore
from repro_torch.agent.geollm.simclock import SimClock
from repro_torch.agent.geollm.workload import WorkloadSampler
from repro_torch.core.distributed_cache import PodLocalCacheRouter


def main():
    clock = SimClock()
    store = GeoDataStore(clock)
    pods = [f"pod{i}" for i in range(4)]
    router = PodLocalCacheRouter(pods, capacity_per_pod=5)

    sampler = WorkloadSampler(reuse_rate=0.8, seed=0)
    tasks = sampler.sample(300)
    keys = [k for t in tasks for k in t.required_keys]

    loader = store.peek
    size = lambda f: f.size_bytes

    t_mark = None
    for i, k in enumerate(keys):
        router.fetch(k, loader, size)
        if i == len(keys) // 2 and t_mark is None:
            # kill a pod mid-stream: its keys fail over deterministically
            victim_pod = router.owner(k)
            print(f"--- killing {victim_pod} at request {i} ---")
            router.fail_pod(victim_pod)
            t_mark = i

    s = router.summary()
    print(json.dumps(s, indent=2))
    print(f"\nlocal hit rate with pod-affinity routing: "
          f"{100 * s['local_hit_rate']:.1f}% over {s['routed']} requests "
          f"({s['failovers']} pod failure)")
    print("rendezvous property: only the dead pod's keys moved; "
          "survivors kept their entire cache (see tests/test_distributed_cache.py)")


if __name__ == "__main__":
    main()
