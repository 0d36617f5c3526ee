# Copied from ray_tpu/rllib/env/policy_client.py (ray_tpu -> ray_tpu_torch).
"""PolicyClient — drive an external env against a served policy
(reference: rllib/env/policy_client.py PolicyClient: the inference-server
pattern where the env lives in ANOTHER process/machine — a game engine, a
simulator farm — and asks the training cluster for actions over HTTP).

stdlib-only on purpose: the client must be importable in external
processes that do not have (or want) this framework installed — the file
is self-contained enough to copy out.
"""

from __future__ import annotations

import json
import urllib.request
import uuid
from typing import Any, Dict, List, Optional


class PolicyClient:
    def __init__(self, address: str, timeout: float = 30.0):
        """address: "http://host:port" of a PolicyServerInput."""
        self.address = address.rstrip("/")
        self.timeout = timeout

    def _call(self, payload: Dict) -> Dict:
        req = urllib.request.Request(
            self.address, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def start_episode(self, episode_id: Optional[str] = None) -> str:
        episode_id = episode_id or uuid.uuid4().hex
        self._call({"command": "START_EPISODE",
                    "episode_id": episode_id})
        return episode_id

    def get_action(self, episode_id: str, observation) -> Any:
        reply = self._call({"command": "GET_ACTION",
                            "episode_id": episode_id,
                            "observation": _to_jsonable(observation)})
        return reply["action"]

    def log_returns(self, episode_id: str, reward: float) -> None:
        self._call({"command": "LOG_RETURNS", "episode_id": episode_id,
                    "reward": float(reward)})

    def end_episode(self, episode_id: str, observation) -> None:
        self._call({"command": "END_EPISODE", "episode_id": episode_id,
                    "observation": _to_jsonable(observation)})


def _to_jsonable(obs) -> List:
    tolist = getattr(obs, "tolist", None)
    return tolist() if tolist else list(obs)
