# Ported from ray_tpu/rllib/env/policy_server_input.py (ray_tpu -> ray_tpu_torch).
"""PolicyServerInput — serve actions to external envs, collect their
transitions for training (reference: rllib/env/policy_server_input.py
PolicyServerInput + env/external_env.py ExternalEnv: the deployment shape
where real-world clients own the env loop and the trainer is a service).

A ThreadingHTTPServer speaks the PolicyClient JSON protocol
(START_EPISODE / GET_ACTION / LOG_RETURNS / END_EPISODE). Inference runs
the module's ``explore_action`` on the CPU on the latest pushed weights
(CPU tensors), drawing from a CPU ``torch.Generator`` seeded with ``seed``;
finished transitions accumulate in a thread-safe buffer that
``sample()`` drains in the same (s, a, r, s', done) layout the env
runners emit — so an off-policy algorithm can swap this in for its
runner fleet with no learner changes.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.env.env_runner import CPU, cpu_weights


class _Episode:
    __slots__ = ("pending_obs", "pending_action", "transitions", "ret",
                 "steps")

    def __init__(self):
        self.pending_obs = None
        self.pending_action = None
        self.transitions: List = []
        self.ret = 0.0
        self.steps = 0


class PolicyServerInput:
    def __init__(self, module_spec, host: str = "127.0.0.1",
                 port: int = 0, seed: int = 0, explore: bool = True):
        self.module = module_spec.build()
        self._weights = None
        self._gen = torch.Generator(device=CPU).manual_seed(seed)
        self._explore = explore
        self._lock = threading.Lock()
        self._episodes: Dict[str, _Episode] = {}
        self._ready: List[Dict] = []       # finished transitions
        self._episode_stats: List[Dict] = []
        self._steps = 0

        server_self = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(length))
                    reply = server_self._handle(payload)
                    code = 200
                except Exception as e:  # surface to the client
                    reply, code = {"error": repr(e)}, 500
                body = json.dumps(reply).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address[:2]
        self.address = f"http://{self.host}:{self.port}"
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="raytpu-policy-server")
        self._thread.start()

    # --------------------------------------------------------- protocol
    def _handle(self, payload: Dict) -> Dict:
        cmd = payload.get("command")
        eid = payload.get("episode_id")
        if cmd == "START_EPISODE":
            with self._lock:
                self._episodes[eid] = _Episode()
            return {"episode_id": eid}
        if cmd == "GET_ACTION":
            obs = np.asarray(payload["observation"], np.float32)
            action = self._infer(obs)
            with self._lock:
                ep = self._episodes[eid]
                # previous (obs, action) pair completes with this obs
                if ep.pending_obs is not None:
                    self._record(ep, next_obs=obs, done=False)
                ep.pending_obs = obs
                ep.pending_action = action
            return {"action": _jsonable(action)}
        if cmd == "LOG_RETURNS":
            with self._lock:
                ep = self._episodes[eid]
                ep.transitions.append(float(payload["reward"]))
                ep.ret += float(payload["reward"])
            return {}
        if cmd == "END_EPISODE":
            obs = np.asarray(payload["observation"], np.float32)
            with self._lock:
                ep = self._episodes.pop(eid)
                if ep.pending_obs is not None:
                    self._record(ep, next_obs=obs, done=True)
                self._episode_stats.append(
                    {"episode_return": ep.ret, "episode_len": ep.steps})
            return {}
        raise ValueError(f"unknown command {cmd!r}")

    def _record(self, ep: _Episode, next_obs, done: bool) -> None:
        # rewards logged since the last GET_ACTION belong to that action
        reward = sum(r for r in ep.transitions
                     if isinstance(r, float))
        ep.transitions.clear()
        self._ready.append({
            "obs": ep.pending_obs, "actions": ep.pending_action,
            "rewards": np.float32(reward), "next_obs": next_obs,
            "dones": np.float32(done)})
        self._steps += 1
        ep.steps += 1
        ep.pending_obs = None

    def _infer(self, obs: np.ndarray):
        if self._weights is None:
            raise RuntimeError(
                "no policy weights pushed yet; call set_weights() or "
                "sample() first")
        batched = obs[None] if obs.ndim == 1 else obs
        # the generator's draws are one stream: requests take turns
        with self._lock, torch.no_grad():
            action, _, _ = self.module.explore_action(
                self._weights, torch.from_numpy(batched), self._gen)
        action = np.asarray(action)
        return action[0] if obs.ndim == 1 else action

    # ------------------------------------------------- algorithm facade
    def set_weights(self, weights) -> None:
        self._weights = cpu_weights(weights)

    def ping(self) -> bool:
        return True

    def sample(self, weights, min_transitions: int = 1,
               timeout: float = 60.0) -> Dict[str, Any]:
        """Drain collected transitions (blocking until min_transitions),
        in the env-runner off-policy layout: [1, N, ...] time-major-
        compatible arrays + valid mask, so `Algorithm.training_step`
        bodies written for runner fragments consume it unchanged."""
        self.set_weights(weights)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if len(self._ready) >= min_transitions:
                    items, self._ready = self._ready, []
                    episodes, self._episode_stats = \
                        self._episode_stats, []
                    break
            time.sleep(0.01)
        else:
            raise TimeoutError(
                f"no transitions from external clients within {timeout}s")
        n = len(items)
        stack = {k: np.stack([it[k] for it in items])[None]
                 for k in ("obs", "actions", "rewards", "next_obs",
                           "dones")}
        stack["valid"] = np.ones((1, n), bool)
        stack["episodes"] = episodes
        stack["env_steps"] = n
        return stack

    def stop(self) -> bool:
        self._server.shutdown()
        self._server.server_close()
        return True


def _jsonable(action):
    arr = np.asarray(action)
    return arr.item() if arr.ndim == 0 else arr.tolist()
