"""Fixture: meter pairing for torch's host->device idioms (never imported —
parsed only).  The scan root for fixtures makes every file in scope.

Every ``unbooked_*`` function is one ``meter-unpaired-transfer``; its
``booked_*`` twin books the copy and is clean; ``never_*`` functions hold
what is not a transfer and stay clean with no meter at all.
"""
import torch


def unbooked_to(buf, device):
    return torch.from_numpy(buf).to(device)         # meter-unpaired-transfer


def booked_to(buf, device, meter):
    t = torch.from_numpy(buf).to(device)
    meter.bytes_cache_upload += t.numel() * t.element_size()
    return t


def unbooked_to_device_kw(buf, dev):
    return torch.from_numpy(buf).to(device=dev, non_blocking=True)


def booked_to_device_kw(buf, dev, meter):
    t = torch.from_numpy(buf).to(device=dev, non_blocking=True)
    meter.bytes_adj_upload += buf.nbytes
    return t


def unbooked_to_string(t):
    return t.to("cuda:0")


def booked_to_string(t, meter):
    meter.bytes_streamed += t.numel() * t.element_size()
    return t.to("cuda:0")


def unbooked_to_torch_device(t):
    return t.to(torch.device("cuda", 0))


def booked_to_torch_device(t, meter):
    out = t.to(torch.device("cuda", 0))
    meter.bytes_streamed += out.numel() * out.element_size()
    return out


def unbooked_to_unclassified(t, where):
    return t.to(where)              # cannot tell: errs toward a finding


def booked_to_unclassified(t, where, meter):
    meter.bytes_streamed += t.numel() * t.element_size()
    return t.to(where)


def unbooked_cuda(t):
    return t.cuda()


def booked_cuda(t, meter):
    meter.bytes_streamed += t.numel() * t.element_size()
    return t.cuda()


def unbooked_as_tensor(ids, dev):
    return torch.as_tensor(ids, device=dev)


def booked_as_tensor(ids, dev, meter):
    meter.bytes_streamed += ids.nbytes
    return torch.as_tensor(ids, device=dev)


def unbooked_tensor(ids, dev):
    return torch.tensor(ids, dtype=torch.int64, device=dev)


def booked_tensor(ids, dev, meter):
    meter.bytes_streamed += ids.nbytes
    return torch.tensor(ids, dtype=torch.int64, device=dev)


def unbooked_copy(host, dev):
    dst = torch.empty(host.shape, dtype=torch.float32, device=dev)
    dst.copy_(torch.from_numpy(host), non_blocking=True)
    return dst


def booked_copy(host, dev, meter):
    dst = torch.empty(host.shape, dtype=torch.float32, device=dev)
    dst.copy_(torch.from_numpy(host), non_blocking=True)
    meter.bytes_cache_upload += host.nbytes
    return dst


def unbooked_copy_into_named(self, pinned):
    self.dev_table.copy_(pinned, non_blocking=True)


def booked_copy_into_named(self, pinned):
    self.dev_table.copy_(pinned, non_blocking=True)
    self.meter.bytes_cache_upload += pinned.numel() * pinned.element_size()


def unbooked_handed_the_meter(mb, device, meter):
    return mb.to(device)            # the meter is passed in but never used


def never_dtype_casts(rows, fb_rows, w, ref):
    a = rows.to(torch.int32)
    b = fb_rows.to(torch.int32)
    c = w.to(torch.int64)
    d = w.to(dtype=torch.float32)
    e = w.to(ref.dtype)
    f = w.to(torch.bfloat16, copy=True)
    return a, b, c, d, e, f


def never_device_allocations(n, k, dev, ref):
    local = torch.arange(n, dtype=torch.int64, device=dev)
    lane = torch.arange(k, dtype=torch.int64, device=dev)
    rows = torch.empty(0, dtype=torch.int32, device=dev)
    zero = torch.zeros((), device=ref.device)
    full = torch.full((n,), 0.5, dtype=torch.float32, device=dev)
    return local, lane, rows, zero, full


def never_device_to_host(t):
    a = t.to("cpu")
    b = t.to(torch.device("cpu"))
    c = t.cpu()
    d = t.detach().cpu().numpy()
    return a, b, c, d


def never_device_to_device(x, dev):
    out = torch.empty_like(x, device=dev)
    src = torch.zeros(x.shape, device=dev)
    out.copy_(src)
    return out


def never_forwards_device(cfg, ds, dev):
    store = FeatureStore(ds.features, ds.graph, cfg, device=dev)  # noqa: F821
    adj = build_device_cache_adj(store, device=dev)               # noqa: F821
    cpu = torch.tensor([1], dtype=torch.int32)
    return store, adj, cpu
