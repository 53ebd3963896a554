'''
Online tracking service: a TCP server that drives the port's streaming seeker
(tcow_tpu_torch/models/streaming.py) for many concurrent client sessions on one device. The
port of tcow_tpu/serving.py, with its wire protocol byte for byte, so a client of either
package talks to a server of either package.

Clients open a session, send a query mask once, then stream RGB frames and get per-frame
snitch / occluder / container mask logits and flags back, with O(window) state on the
device. With batch_slots = 1 each session owns a StreamState of batch 1 and its frames run
one stream_step each, bit-equal to a direct stream. With batch_slots > 1 the server runs
continuous batching: sessions of one (window, pinned, cache size) geometry become slots of
one multi-session state (stream_step_multi, a stream position per slot), and a dispatcher
thread folds every pending frame into ONE batched step, so the fixed cost of a step (the
host launching its kernels) is shared by every active session. Every step of either kind
runs K1 once per block for the spatial attention, whatever the batch.

Device access is serialized by one lock. torch.inference_mode and the current CUDA device
are thread-local, so every thread that steps enters both (`_compute`). Frames go up as
uint8 from pinned host memory and are normalised on the device (f_u8.float() / 255,
q_u8 > 127: the host conversion's values bit for bit); masks come back as float16 cast on
the device (IEEE round-to-nearest, the values of a host cast). A step that fails is
reported to its sessions and the group's state is rebuilt (an epoch bump); nothing runs
anywhere else in its place.

Wire protocol (stdlib-only, length-prefixed):
  frame := uint32_be header_len | uint32_be payload_len | header JSON | payload bytes
  client -> server commands:
    {"cmd": "open", "window": W}              W=0: unbounded cache of "max_frames" slots
    {"cmd": "frame", "has_query": bool}       payload: rgb uint8 (H,W,3) [+ query uint8 (H,W)]
    {"cmd": "stats"} | {"cmd": "close"}
    {"cmd": "reload", "path": "..."}          hot-swap weights (needs params_loader);
                                              invalidates every open session, unless the
                                              server runs with migrate_sessions=True, in
                                              which case live sessions are rebuilt
                                              (frame-ring replay) on their next frame
  server -> client replies:
    open  -> {"ok", "session", "height", "width", "mask_channels", "flag_channels"}
    frame -> {"ok", "t", "flags": [..]|null}  payload: mask logits float16 (C,H,W)
    any error -> {"ok": false, "error": msg}  (the session stays usable unless the socket died)
'''

import contextlib
import json
import socket
import struct
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tcow_tpu_torch import resolve_device
from tcow_tpu_torch.models import streaming
from tcow_tpu_torch.models.mask_tracker import MaskTracker
from tcow_tpu_torch.weights import params_from_jax

_HDR = struct.Struct('>II')
_MAX_HEADER = 1 << 20
_MAX_PAYLOAD = 1 << 28
_NULL_LOCK = contextlib.nullcontext()


def send_msg(sock: socket.socket, header: Dict[str, Any], payload: bytes = b'') -> None:
    h = json.dumps(header).encode('utf-8')
    sock.sendall(_HDR.pack(len(h), len(payload)) + h + payload)


def _recvall(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def recv_msg(sock: socket.socket) -> Optional[Tuple[Dict[str, Any], bytes]]:
    '''Returns (header, payload) or None on clean EOF.'''
    raw = _recvall(sock, _HDR.size)
    if raw is None:
        return None
    hlen, plen = _HDR.unpack(raw)
    if hlen > _MAX_HEADER or plen > _MAX_PAYLOAD:
        raise ValueError(f'oversized message: header {hlen}, payload {plen}')
    h = _recvall(sock, hlen)
    p = _recvall(sock, plen) if plen else b''
    if h is None or p is None:
        raise ConnectionError('peer closed mid-message')
    return json.loads(h.decode('utf-8')), p


class _StaleBatch(ValueError):
    '''Raised by the dispatcher when a recycle() landed between grabbing a batch and
    stepping it. A distinct type: other ValueErrors of the step must still take the
    recycle path (the step may have written part of the state).'''


class _Session:
    def __init__(self, sid: int, state, capacity: Optional[int],
                 group: Optional['_BatchGroup'] = None, slot: int = -1,
                 epoch: int = 0, params_epoch: int = 0,
                 window: Optional[int] = None, pinned: int = 1,
                 retain_frames: bool = False):
        self.sid = sid
        self.params_epoch = params_epoch
        self.state = state         # dedicated mode only (None when batched)
        self.capacity = capacity   # None = windowed (any length)
        self.group = group         # batched mode: continuous-batching group + slot
        self.slot = slot
        self.epoch = epoch         # group epoch at open; stale => caches were lost
        self.window = window
        self.pinned = pinned
        self.t = 0                 # host mirror of the session's stream position
        # Migration ring (migrate_sessions=True): the frames whose keys and values the
        # device cache still holds, kept as received (uint8; None = no query on that
        # frame). Windowed sessions retain the pinned prefix and the last (window -
        # pinned) frames, as the cache does, so a replay rebuilds everything the model
        # could still attend to. ~window * H*W*3 bytes per session.
        self.retain_frames = retain_frames
        self.ring: list = []

    def retain(self, rgb_u8: np.ndarray, qmask_u8: np.ndarray) -> None:
        if not self.retain_frames:
            return
        self.ring.append((rgb_u8, qmask_u8 if qmask_u8.any() else None))
        if self.window is not None and len(self.ring) > self.window:
            self.ring = self.ring[:self.pinned] \
                + self.ring[-(self.window - self.pinned):]


class _FrameBox:
    '''One pending frame request inside a batch group.'''

    def __init__(self, rgb: np.ndarray, qmask: np.ndarray):
        self.rgb = rgb
        self.qmask = qmask
        self.done = threading.Event()
        self.mask: Optional[np.ndarray] = None
        self.flags: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class _BatchGroup:
    '''Continuous batching: all sessions sharing one (window, pinned, cache-size) geometry
    live as slots of ONE multi-session StreamState (streaming.stream_step_multi), and a
    dispatcher thread folds every pending frame request into a single batched step.
    Sessions sit at different stream positions (a t per slot, on the device); whoever has
    a frame pending when a step launches rides it, everyone else catches the next one.'''

    def __init__(self, server: 'TrackerServer', window: Optional[int], pinned: int,
                 tmax: int, slots: int):
        self.server = server
        self.window, self.pinned, self.tmax, self.slots = window, pinned, tmax, slots
        with server._device_lock, server._compute():
            self.state = self._fresh_state()
        self.free = list(range(slots))
        self.pending: Dict[int, _FrameBox] = {}
        self.attached = 0   # open connections referencing this group (eviction guard)
        self.cond = threading.Condition()
        # Bumped whenever the device state is rebuilt after a failed step: sessions from
        # an older epoch have lost their caches and must reopen (see submit()).
        self.epoch = 0
        self.stopped = threading.Event()   # set when the server evicts this group
        self.steps = 0
        self.frames = 0
        self.step_ms = 0.0
        self._ema_step_ms: Optional[float] = None
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name='tracker-batch', daemon=True)
        self._thread.start()

    def _fresh_state(self):
        '''Caller holds the device lock.'''
        return streaming.init_stream_multi(
            self.server.model, self.slots, max_frames=None if self.window else self.tmax,
            window=self.window, pinned_frames=self.pinned)

    def _step(self, frames_u8: np.ndarray, queries_u8: np.ndarray, active: np.ndarray):
        '''One batched step from uint8 frames; caller holds the device lock inside
        server._compute(). Returns (masks (slots, C, H, W) float16, flags (slots, F) f32 or
        None) on the host.'''
        srv = self.server
        f = srv._upload(frames_u8).float() / 255.0
        q = (srv._upload(queries_u8) > 127).float()
        a = srv._upload(active)
        self.state, masks, flags = streaming.stream_step_multi(
            srv.model, self.state, f, q, a, window=self.window, pinned_frames=self.pinned)
        return (masks.to(torch.float16).cpu().numpy(),
                None if flags is None else flags.float().cpu().numpy())

    def recycle(self, error: Optional[BaseException] = None,
                _device_locked: bool = False) -> None:
        '''Invalidate EVERY session of this group and rebuild its device state, after a
        failed step (which may have written part of the state) or a weight reload. Atomic
        with respect to the dispatcher: the state swap and epoch bump happen together
        under the device lock, and the dispatcher re-reads the epoch under that lock before
        stepping, so a batch grabbed before cannot run against the fresh state. If even
        the rebuild fails the group is stopped; either way every pending request fails.'''
        msg = ('session state was lost (device error, weight reload, or group '
               'eviction); close and reopen the session'
               + (f' [{error}]' if error is not None else ''))
        lock = _NULL_LOCK if _device_locked else self.server._device_lock
        try:
            with lock, self.server._compute():
                new_state = self._fresh_state()
                with self.cond:
                    self.state = new_state
                    self.epoch += 1
                    self.free = list(range(self.slots))
                    # _StaleBatch (a ValueError): these frames were invalidated BEFORE
                    # running, like a grabbed-then-recycled batch; a migrating server
                    # retries them, otherwise the client sees the reopen error.
                    self._fail_pending_locked(_StaleBatch(msg))
        except Exception:   # noqa: BLE001 — device unusable; stop the group
            self.stopped.set()
            with self.cond:
                self._fail_pending_locked(ValueError(msg))

    def _fail_pending_locked(self, err: BaseException) -> None:
        '''Caller holds self.cond.'''
        for b in self.pending.values():
            b.error = err
            b.done.set()
        self.pending.clear()

    def alloc_slot(self) -> Tuple[int, int]:
        while True:
            with self.cond:
                if self.stopped.is_set():
                    raise ValueError('batch group was stopped; retry the open')
                if not self.free:
                    raise ValueError(f'batch group full ({self.slots} sessions for '
                                     f'window={self.window or 0}); retry later')
                slot = self.free.pop()
                epoch = self.epoch
            with self.server._device_lock, self.server._compute():
                if self.epoch == epoch and not self.stopped.is_set():
                    self.state = streaming.reset_stream_slot(self.state, slot)
                    return slot, epoch
            # A recycle() intervened (the slot list was rebuilt): take a fresh slot.

    def release_slot(self, slot: int, epoch: int) -> None:
        with self.cond:
            if epoch != self.epoch:
                # After a recycle the slot may already belong to a NEW session; touching
                # pending here could discard (and hang) that session's in-flight frame.
                return
            if slot not in self.free:
                self.free.append(slot)
            box = self.pending.pop(slot, None)
            if box is not None:
                box.error = ValueError('session closed with a frame in flight')
                box.done.set()

    def idle(self) -> bool:
        with self.cond:
            if self.server.migrate_sessions:
                # After a recycle every slot is free, but sessions awaiting migration
                # still reference this group: evicting it would break the zero-downtime
                # contract for an unrelated open. Idle = no open connection at all.
                return self.attached == 0
            return len(self.free) == self.slots

    def submit(self, slot: int, epoch: int, rgb: np.ndarray, qmask: np.ndarray
               ) -> _FrameBox:
        box = _FrameBox(rgb, qmask)
        with self.cond:
            if epoch != self.epoch or self.stopped.is_set():
                raise ValueError('session state was lost (device error or group '
                                 'eviction); close and reopen the session')
            if slot in self.pending:
                raise ValueError('one frame in flight per session')
            self.pending[slot] = box
            self.cond.notify()
        return box

    def _dispatch_loop(self) -> None:
        H, W = self.server.cfg.frame_height, self.server.cfg.frame_width
        while not (self.server._stopping.is_set() or self.stopped.is_set()):
            with self.cond:
                if not self.pending:
                    self.cond.wait(timeout=0.25)
                if self.pending:
                    # Adaptive batching window: requests arrive skewed (clients unblock
                    # at slightly different times), so grabbing at once runs half-full
                    # batches. Waiting a small fraction of the step time for stragglers
                    # costs little latency; bounded so an idle or slow session never
                    # stalls the batch.
                    wait_s = min(0.05, (self._ema_step_ms or 0.0) * 1.5e-4)
                    deadline = time.time() + wait_s
                    while len(self.pending) < self.slots - len(self.free):
                        rem = deadline - time.time()
                        if rem <= 0:
                            break
                        self.cond.wait(rem)
                batch = dict(self.pending)
                self.pending.clear()
                epoch_at_grab = self.epoch
            if not batch:
                continue
            frames = np.zeros((self.slots, 3, H, W), np.uint8)
            queries = np.zeros((self.slots, 1, H, W), np.uint8)
            active = np.zeros((self.slots,), bool)
            for slot, box in batch.items():
                frames[slot] = box.rgb[0]
                queries[slot] = box.qmask[0]
                active[slot] = True
            try:
                t0 = time.time()
                with self.server._device_lock, self.server._compute():
                    if self.epoch != epoch_at_grab or self.stopped.is_set():
                        # A recycle() (failed step elsewhere, weight reload, eviction)
                        # landed between grabbing this batch and stepping: these frames
                        # belong to invalidated sessions and must NOT run on the fresh
                        # state or the new weights.
                        raise _StaleBatch('session state was lost (weight reload or '
                                          'group recycle); close and reopen the session')
                    masks_np, flags_np = self._step(frames, queries, active)
                dt_ms = (time.time() - t0) * 1e3
                self.steps += 1
                self.frames += len(batch)
                self.step_ms += dt_ms
                self._ema_step_ms = dt_ms if self._ema_step_ms is None else \
                    0.8 * self._ema_step_ms + 0.2 * dt_ms
                for slot, box in batch.items():
                    box.mask = masks_np[slot]
                    box.flags = None if flags_np is None else flags_np[slot]
            except _StaleBatch as e:     # sessions already invalidated; state untouched
                for box in batch.values():
                    box.error = e
            except Exception as e:   # noqa: BLE001 — reported to every request
                # Application errors keep connections alive, so wrap the device error in
                # the ValueError the protocol layer treats as such.
                err = ValueError(f'device step failed; session lost — close and reopen '
                                 f'the session [{e}]')
                for box in batch.values():
                    box.error = err
                # The failed step may have written part of the caches: rebuild the state,
                # bump the epoch and fail any newly pending boxes.
                self.recycle(e)
            finally:
                for box in batch.values():
                    box.done.set()


class TrackerServer:
    '''Serves streaming tracking sessions over TCP.

    :param params: seeker params, the JAX-layout tree of numpy arrays (load_networks);
        the server builds one MaskTracker from them on `device`.
    :param cfg: mask_tracker.SeekerConfig (must have causal_attention == 1).
    :param port: 0 picks an ephemeral port (see .address after start()).
    :param default_max_frames: cache slots for unbounded (window=0) sessions.
    :param batch_slots: >1 turns on continuous batching: sessions with the same
        (window, pinned, cache-size) geometry share one multi-session state of this many
        slots, and every step serves ALL their pending frames at once. 1 = one dedicated
        B=1 state and step per session (bit-equal to a direct stream_step).
    :param max_groups: cap on concurrently live batch-group geometries.
    :param max_cache_bytes: AGGREGATE cache budget across all live batch groups
        (client-chosen geometries are evicted when idle or rejected beyond it).
    :param device: 'cuda' (default; raises without CUDA) or 'cpu'.
    '''

    def __init__(self, params, cfg, host: str = '127.0.0.1', port: int = 0,
                 default_max_frames: Optional[int] = None, batch_slots: int = 1,
                 max_groups: int = 4, params_loader=None,
                 max_cache_bytes: int = 8 << 30, migrate_sessions: bool = False,
                 device='cuda'):
        if cfg.causal_attention != 1:
            raise ValueError('serving requires causal_attention == 1')
        if batch_slots < 1:
            raise ValueError(f'batch_slots must be >= 1, got {batch_slots}')
        self.device = resolve_device(device)
        self.max_cache_bytes = max_cache_bytes
        # Zero-downtime swaps: when True, a session whose device cache was invalidated (a
        # weight reload, or a group recycle after a failed step) is migrated on its next
        # frame (its retained frame ring replayed through the current weights) instead
        # of erroring with "close and reopen". Costs O(window) host memory per session
        # and O(window) steps per migration.
        self.migrate_sessions = migrate_sessions
        self._migrations = 0
        # Optional `path -> params tree` callback enabling the 'reload' command
        # (checkpoint hot-swap without restarting the server). None disables it.
        self.params_loader = params_loader
        self.cfg = cfg
        self.model = MaskTracker(cfg, device=self.device)
        self.model.load_state_dict(params_from_jax(params))
        self.model.eval()
        self._host, self._port = host, port
        self.default_max_frames = default_max_frames or cfg.num_total_frames
        self.batch_slots = batch_slots
        self.max_groups = max_groups
        self._groups: Dict[Tuple[Optional[int], int, int], _BatchGroup] = {}
        self._groups_lock = threading.Lock()
        self._create_lock = threading.Lock()   # taken before the device lock, never after
        self._device_lock = threading.Lock()
        self._sessions_lock = threading.Lock()
        self._next_sid = 0
        self._active_sessions = 0
        self._frames_served = 0
        self._params_epoch = 0   # bumped by reload_params; stale sessions must reopen
        self._ema_ms: Optional[float] = None
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._conn_threads = []
        self._stopping = threading.Event()

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> Tuple[str, int]:
        self._sock = socket.create_server((self._host, self._port))
        self._sock.settimeout(0.25)
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               name='tracker-accept', daemon=True)
        self._accept_thread.start()
        return self.address

    @property
    def address(self) -> Tuple[str, int]:
        if self._sock is None:
            raise RuntimeError('server not started')
        return self._sock.getsockname()[:2]

    def stop(self) -> None:
        self._stopping.set()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)
        if self._sock is not None:
            self._sock.close()
        for t in list(self._conn_threads):
            t.join(timeout=5)
        with self._groups_lock:
            groups = list(self._groups.values())
        for g in groups:
            with g.cond:
                g.cond.notify_all()
            g._thread.join(timeout=5)

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name='tracker-conn', daemon=True)
            t.start()
            self._conn_threads = [x for x in self._conn_threads if x.is_alive()]
            self._conn_threads.append(t)

    # -- model plumbing -------------------------------------------------------

    @contextlib.contextmanager
    def _compute(self):
        '''The thread-local settings of a step: inference mode and the server's device
        as the current one on a GPU; on the CPU the process's intra-op thread count,
        which OpenMP keeps per thread (a new thread starts at the library's default, and
        a CPU GEMM's rounding depends on how many threads split it).'''
        if self.device.type == 'cpu':
            torch.set_num_threads(torch.get_num_threads())
        with torch.inference_mode(), (torch.cuda.device(self.device)
                                      if self.device.type == 'cuda'
                                      else contextlib.nullcontext()):
            yield

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        '''A host array on the server's device, copied from pinned memory on a GPU.'''
        t = torch.from_numpy(np.array(arr, order='C'))
        if self.device.type == 'cuda':
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def reload_params(self, params) -> int:
        '''Checkpoint hot-swap: replaces the served weights (the JAX-layout params tree)
        without restarting the server. Live sessions' caches were computed under the OLD
        weights, so every open session is invalidated (its next frame gets a "reopen"
        error or, with migrate_sessions=True, a rebuild that replays its retained frames
        through the new weights). Returns the new params epoch.

        Atomicity: the weight copy into the model, the dedicated-session epoch bump and
        every group's recycle happen under ONE hold of the device lock, and both step
        paths re-check their epoch under that lock, so no frame of a session opened
        before the reload runs against the new weights. Lock order is create -> device
        -> (sessions | groups | group.cond); nothing else takes the device lock while
        holding those.'''
        new_state = {k: v.to(self.device) for k, v in params_from_jax(params).items()}
        with self._device_lock:
            self.model.load_state_dict(new_state)
            with self._sessions_lock:
                self._params_epoch += 1
                epoch = self._params_epoch
            with self._groups_lock:
                groups = list(self._groups.values())
            for g in groups:
                g.recycle(_device_locked=True)
        return epoch

    def _dedicated_step(self, sess: _Session, rgb_u8: np.ndarray, qmask_u8: np.ndarray):
        '''One frame of a dedicated session; caller holds the device lock inside
        _compute(). Returns (mask (C, H, W) float16, flags (F,) f32 or None) on the
        host.'''
        f = self._upload(rgb_u8).float() / 255.0
        q = (self._upload(qmask_u8) > 127).float()
        sess.state, mask, flags = streaming.stream_step(
            self.model, sess.state, f, q, window=sess.window, pinned_frames=sess.pinned)
        return (mask[0].to(torch.float16).cpu().numpy(),
                None if flags is None else flags[0].float().cpu().numpy())

    def _cache_bytes(self, tmax: int, slots: int) -> int:
        bb = self.cfg.backbone_config()
        itemsize = bb.compute_dtype.itemsize
        return slots * bb.depth * 2 * bb.num_patches * bb.embed_dim * itemsize * tmax

    def _validate_geometry(self, window: Optional[int], pinned: int, tmax: int,
                           slots: int) -> None:
        '''The geometry comes from the client header, so bound it BEFORE any device
        allocation: no open may request more cache than the whole budget.'''
        if window is not None and not (window > pinned >= 1):
            raise ValueError(f'need window > pinned_frames >= 1, got '
                             f'window={window} pinned_frames={pinned}')
        if tmax < 1:
            raise ValueError(f'need at least one cache slot, got {tmax}')
        cache_bytes = self._cache_bytes(tmax, slots)
        if cache_bytes > self.max_cache_bytes:
            raise ValueError(
                f'requested geometry needs {cache_bytes / 2**30:.1f} GiB of KV cache '
                f'(> {self.max_cache_bytes / 2**30:.1f} GiB limit); lower "window" or '
                f'"max_frames"')

    def _evict_for_capacity_locked(self, needed_bytes: int) -> None:
        '''Caller holds _groups_lock. Evicts idle groups until BOTH the group-count cap
        and the aggregate cache byte budget admit one more group of `needed_bytes`;
        raises if live (non-idle) groups alone exceed either bound.'''
        def over():
            total = sum(self._cache_bytes(g.tmax, g.slots)
                        for g in self._groups.values())
            return (len(self._groups) >= self.max_groups
                    or total + needed_bytes > self.max_cache_bytes)
        while over():
            idle = next((k for k, g in self._groups.items() if g.idle()), None)
            if idle is None:
                raise ValueError(
                    f'server at capacity ({len(self._groups)} active session '
                    f'geometries); reuse an existing window/max_frames or retry later')
            self._groups.pop(idle).stopped.set()

    def _open_session(self, header: Dict[str, Any]) -> _Session:
        window = int(header.get('window', 0)) or None
        pinned = int(header.get('pinned_frames', 1))
        if window is None:
            # pinned_frames is a dead parameter in unbounded mode (slot == frame index);
            # normalized so that clients cannot mint distinct group keys from it.
            pinned = 1
        max_frames = int(header.get('max_frames', 0)) or self.default_max_frames
        capacity = None if window else max_frames
        tmax = window if window else max_frames
        if self.batch_slots > 1:
            self._validate_geometry(window, pinned, tmax, self.batch_slots)
            needed = self._cache_bytes(tmax, self.batch_slots)
            key = (window, pinned, tmax)
            # One open at a time looks up and builds groups: opens of a new geometry that
            # raced each built a full state (batch_slots caches) before all but one were
            # dropped. The group is built outside _groups_lock: its constructor takes the
            # device lock, and reload_params takes _groups_lock while holding it.
            with self._create_lock:
                with self._groups_lock:
                    group = self._groups.get(key)
                    if group is not None and group.stopped.is_set():
                        del self._groups[key]
                        group = None
                    if group is None:
                        self._evict_for_capacity_locked(needed)
                if group is None:
                    params_epoch_before = self._params_epoch
                    group = _BatchGroup(self, window, pinned, tmax, self.batch_slots)
                    with self._groups_lock:
                        self._groups[key] = group
                    if params_epoch_before != self._params_epoch:
                        # A reload landed while the group was being built.
                        group.recycle()
            slot, epoch = group.alloc_slot()
            with group.cond:
                group.attached += 1
            with self._sessions_lock:
                sid = self._next_sid
                self._next_sid += 1
                self._active_sessions += 1
            return _Session(sid, None, capacity, group=group, slot=slot,
                            epoch=epoch, params_epoch=self._params_epoch,
                            window=window, pinned=pinned,
                            retain_frames=self.migrate_sessions)
        self._validate_geometry(window, pinned, tmax, 1)
        with self._device_lock, self._compute():
            state = streaming.init_stream(self.model, 1,
                                          max_frames=None if window else max_frames,
                                          window=window, pinned_frames=pinned)
        with self._sessions_lock:
            sid = self._next_sid
            self._next_sid += 1
            self._active_sessions += 1
        return _Session(sid, state, capacity=capacity, params_epoch=self._params_epoch,
                        window=window, pinned=pinned, retain_frames=self.migrate_sessions)

    def _run_frame(self, sess: _Session, rgb_u8: np.ndarray, qmask_u8: np.ndarray):
        '''rgb_u8 (1, 3, H, W) uint8, qmask_u8 (1, 1, H, W) uint8 (0 when no query).'''
        t0 = time.time()
        if sess.group is not None:
            mask_np, flags_np = self._batched_frame(sess, rgb_u8, qmask_u8)
        else:
            with self._device_lock, self._compute():
                # Checked under the device lock: reload_params swaps weights and bumps
                # the epoch under this lock, so the check and the step are atomic with
                # respect to it (old caches never mix with new weights).
                if sess.params_epoch != self._params_epoch:
                    if not self.migrate_sessions:
                        raise ValueError('weights were reloaded; close and reopen the '
                                         'session')
                    self._replay_dedicated_locked(sess)
                mask_np, flags_np = self._dedicated_step(sess, rgb_u8, qmask_u8)
        sess.retain(rgb_u8, qmask_u8)
        dt_ms = (time.time() - t0) * 1e3
        with self._sessions_lock:
            self._frames_served += 1
            self._ema_ms = dt_ms if self._ema_ms is None else \
                0.9 * self._ema_ms + 0.1 * dt_ms
        return mask_np, flags_np

    def _batched_frame(self, sess: _Session, rgb_u8: np.ndarray, qmask_u8: np.ndarray):
        '''One frame through the continuous-batching path, migrating the session first
        when its group state was invalidated (weight reload or recycle) and
        migrate_sessions is on. Bounded retries: reloads can land mid-flight.'''
        group = sess.group
        last_err = None
        for _ in range(3):
            stale = (sess.params_epoch != self._params_epoch
                     or sess.epoch != group.epoch)
            if stale or group.stopped.is_set():
                if not self.migrate_sessions or group.stopped.is_set():
                    raise ValueError('session state was lost (weight reload, device '
                                     'error, or group eviction); close and reopen the '
                                     'session')
                try:
                    self._migrate_batched(sess)
                except ValueError as e:
                    # A reload or recycle can land mid-replay; the session is left stale,
                    # so the next attempt migrates again from scratch.
                    last_err = e
                    continue
            try:
                box = group.submit(sess.slot, sess.epoch, rgb_u8, qmask_u8)
            except ValueError:
                if not self.migrate_sessions:
                    raise
                continue   # a recycle landed between the check and the submit
            box.done.wait()
            if box.error is None:
                return box.mask, box.flags
            if isinstance(box.error, _StaleBatch) and self.migrate_sessions:
                continue   # invalidated mid-flight; migrate and resubmit this frame
            if isinstance(box.error, (ValueError, AssertionError)):
                raise box.error
            # Any other error type is reported as an application error, so that the
            # connection survives per the protocol.
            raise ValueError(f'device step failed: {box.error}')
        raise last_err if last_err is not None else ValueError(
            'session migration kept racing reloads/recycles; close and reopen the '
            'session')

    def _migrate_batched(self, sess: _Session) -> None:
        '''Rebuilds a batched session on the CURRENT group state and weights: a fresh slot
        and the retained frame ring replayed through the normal submit path (replays of
        sessions migrating at once fold into shared batched steps). The rebuilt cache
        equals a fresh session fed the retained frames under the new weights.'''
        H, W = self.cfg.frame_height, self.cfg.frame_width
        # No-op when the group epoch moved (the recycle already reclaimed every slot);
        # frees the slot in the params-epoch-only case so that no session holds two.
        sess.group.release_slot(sess.slot, sess.epoch)
        sess.slot, sess.epoch = sess.group.alloc_slot()
        sess.params_epoch = self._params_epoch
        for rgb_u8, q in sess.ring:
            qm = q if q is not None else np.zeros((1, 1, H, W), np.uint8)
            box = sess.group.submit(sess.slot, sess.epoch, rgb_u8, qm)
            box.done.wait()
            if box.error is not None:
                # Poison the session: a half-replayed slot must never serve a frame.
                sess.epoch = -1
                raise ValueError('session migration replay failed; retrying or reopen '
                                 f'the session [{box.error}]')
        with self._sessions_lock:
            self._migrations += 1

    def _replay_dedicated_locked(self, sess: _Session) -> None:
        '''Caller holds the device lock inside _compute() (so no reload can interleave).
        Rebuilds a dedicated session's stream state under the current weights by
        replaying its retained frame ring.'''
        sess.state = streaming.init_stream(
            self.model, 1, max_frames=sess.capacity if sess.window is None else None,
            window=sess.window, pinned_frames=sess.pinned)
        for rgb_u8, q in sess.ring:
            qm = q if q is not None else np.zeros(rgb_u8.shape[:1] + (1,) + rgb_u8.shape[2:],
                                                  np.uint8)
            self._dedicated_step(sess, rgb_u8, qm)
        sess.params_epoch = self._params_epoch
        with self._sessions_lock:
            self._migrations += 1

    # -- connection handling ---------------------------------------------------

    def _serve_conn(self, conn: socket.socket) -> None:
        cfg = self.cfg
        H, W = cfg.frame_height, cfg.frame_width
        sess: Optional[_Session] = None
        try:
            while not self._stopping.is_set():
                try:
                    msg = recv_msg(conn)
                except ValueError as e:
                    # Broken framing (oversized lengths, invalid header JSON; a
                    # JSONDecodeError is a ValueError): the byte stream is no longer
                    # trustworthy, so reply once and drop the connection.
                    try:
                        send_msg(conn, {'ok': False, 'error': f'protocol error: {e}'})
                    except OSError:
                        pass
                    break
                if msg is None:
                    break
                header, payload = msg
                if not isinstance(header, dict):
                    send_msg(conn, {'ok': False, 'error': 'header must be a JSON object'})
                    continue
                cmd = header.get('cmd')
                try:
                    if cmd == 'open':
                        if sess is not None:
                            raise ValueError('session already open on this connection')
                        sess = self._open_session(header)
                        send_msg(conn, {'ok': True, 'session': sess.sid,
                                        'height': H, 'width': W,
                                        'mask_channels': cfg.output_channels,
                                        'flag_channels': cfg.flag_channels})
                    elif cmd == 'frame':
                        if sess is None:
                            raise ValueError('open a session first')
                        if sess.capacity is not None and sess.t >= sess.capacity:
                            raise ValueError(
                                f'unbounded session is full at {sess.capacity} frames; '
                                f'open with "window" for arbitrary-length streams')
                        nrgb = H * W * 3
                        has_q = bool(header.get('has_query', False))
                        want = nrgb + (H * W if has_q else 0)
                        if len(payload) != want:
                            raise ValueError(f'payload is {len(payload)} bytes, '
                                             f'expected {want}')
                        rgb = np.frombuffer(payload, np.uint8, count=nrgb)
                        rgb = rgb.reshape(H, W, 3).transpose(2, 0, 1)[None]
                        if has_q:
                            q = np.frombuffer(payload, np.uint8, offset=nrgb)
                            q = q.reshape(H, W)[None, None]
                        else:
                            q = np.zeros((1, 1, H, W), np.uint8)
                        mask_np, flags_np = self._run_frame(sess, rgb, q)
                        send_msg(conn, {'ok': True, 't': sess.t,
                                        'flags': None if flags_np is None
                                        else [float(f) for f in flags_np]},
                                 mask_np.tobytes())
                        sess.t += 1
                    elif cmd == 'stats':
                        with self._groups_lock:
                            groups = [
                                {'window': g.window or 0, 'pinned': g.pinned,
                                 'cache_slots': g.tmax,
                                 'live_sessions': g.slots - len(g.free),
                                 'steps': g.steps, 'frames': g.frames,
                                 'avg_batch': g.frames / g.steps if g.steps else None}
                                for g in self._groups.values()]
                        with self._sessions_lock:
                            send_msg(conn, {'ok': True,
                                            'active_sessions': self._active_sessions,
                                            'frames_served': self._frames_served,
                                            'ms_per_frame_ema': self._ema_ms,
                                            'params_epoch': self._params_epoch,
                                            'migrations': self._migrations,
                                            'batch_groups': groups})
                    elif cmd == 'reload':
                        if self.params_loader is None:
                            raise ValueError('reload is disabled on this server '
                                             '(no params_loader configured)')
                        path = header.get('path')
                        if not isinstance(path, str) or not path:
                            raise ValueError('reload needs a "path" string')
                        try:
                            new_params = self.params_loader(path)
                        except (ValueError, AssertionError):
                            raise
                        except Exception as e:   # corrupt or missing checkpoint etc.
                            raise ValueError(f'reload failed: {e!r}') from e
                        epoch = self.reload_params(new_params)
                        send_msg(conn, {'ok': True, 'params_epoch': epoch})
                    elif cmd == 'close':
                        send_msg(conn, {'ok': True})
                        break
                    else:
                        raise ValueError(f'unknown cmd {cmd!r}')
                except (ValueError, AssertionError) as e:
                    # Application errors keep the connection alive.
                    send_msg(conn, {'ok': False, 'error': str(e)})
        except (ConnectionError, OSError):
            pass  # peer vanished; just clean up
        finally:
            if sess is not None:
                if sess.group is not None:
                    sess.group.release_slot(sess.slot, sess.epoch)
                    with sess.group.cond:
                        sess.group.attached -= 1
                with self._sessions_lock:
                    self._active_sessions -= 1
            conn.close()


class TrackerClient:
    '''Minimal blocking client for TrackerServer (one session per connection).'''

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self.meta: Optional[Dict[str, Any]] = None

    def _rpc(self, header: Dict[str, Any], payload: bytes = b''):
        send_msg(self._sock, header, payload)
        msg = recv_msg(self._sock)
        if msg is None:
            raise ConnectionError('server closed the connection')
        reply, rpayload = msg
        if not reply.get('ok'):
            raise RuntimeError(f'server error: {reply.get("error")}')
        return reply, rpayload

    def open(self, window: int = 0, max_frames: int = 0,
             pinned_frames: int = 1) -> Dict[str, Any]:
        self.meta, _ = self._rpc({'cmd': 'open', 'window': window,
                                  'max_frames': max_frames,
                                  'pinned_frames': pinned_frames})
        return self.meta

    def track(self, rgb_uint8: np.ndarray, query_mask: Optional[np.ndarray] = None):
        '''rgb_uint8 (H, W, 3) uint8 at the server's resolution; query_mask (H, W)
        uint8/bool at the query frame. Returns (mask_logits (C, H, W) float16,
        flags list|None, t).'''
        if self.meta is None:
            # No session metadata: forward as is and let the server reject it ("open a
            # session first"), so misuse surfaces as a server error.
            self._rpc({'cmd': 'frame', 'has_query': query_mask is not None},
                      rgb_uint8.tobytes())
            raise RuntimeError('the server accepted a frame before open')
        H, W = self.meta['height'], self.meta['width']
        if rgb_uint8.shape != (H, W, 3) or rgb_uint8.dtype != np.uint8:
            raise ValueError(f'need uint8 ({H}, {W}, 3), got {rgb_uint8.dtype} '
                             f'{rgb_uint8.shape}')
        payload = rgb_uint8.tobytes()
        has_q = query_mask is not None
        if has_q:
            qm = (np.asarray(query_mask) > 0).astype(np.uint8) * 255
            if qm.shape != (H, W):
                raise ValueError(f'query mask {qm.shape}, need {(H, W)}')
            payload += qm.tobytes()
        reply, rpayload = self._rpc({'cmd': 'frame', 'has_query': has_q}, payload)
        C = self.meta['mask_channels']
        mask = np.frombuffer(rpayload, np.float16).reshape(C, H, W)
        return mask, reply.get('flags'), reply['t']

    def stats(self) -> Dict[str, Any]:
        return self._rpc({'cmd': 'stats'})[0]

    def reload(self, path: str) -> int:
        '''Hot-swaps the server's weights from a checkpoint path (the server must have a
        params_loader). Every open session is invalidated.'''
        return self._rpc({'cmd': 'reload', 'path': path})[0]['params_epoch']

    def close(self) -> None:
        try:
            self._rpc({'cmd': 'close'})
        except (OSError, RuntimeError, ValueError):
            pass
        self._sock.close()
