"""The API edge: everything that talks JSON to a kube-apiserver.

The device never sees a string; this package converts between Kubernetes
objects and engine rows:

- render: dirty rows -> status documents (plain dict builders)
- merge: strategic-merge + no-op suppression semantics
- kubeclient: the list/watch/patch protocol the engine consumes
- httpclient: that protocol over a real kube-apiserver (HTTP(S))
- mockserver: a small apiserver speaking that protocol, in memory and
  over HTTP
"""

from kwok_tpu_torch.edge.selectors import LabelSelector, parse_selector
from kwok_tpu_torch.edge.ippool import IPPool

__all__ = ["LabelSelector", "parse_selector", "IPPool"]
