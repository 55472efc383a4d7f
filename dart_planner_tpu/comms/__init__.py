"""Edge<->cloud communication boundary.

This framework runs the whole plan->control stack in one
process (SURVEY.md section 2.7), so these transports survive only as the
*system boundary*: talking to a remote edge box, ground station, or demo
UI. Semantics mirror the reference ``communication/`` package: ZMQ
REQ/REP with HMAC-SHA256-signed JSON (+TTL), a heartbeat monitor with
emergency callback, and gzip/binary telemetry compression.
"""

from dart_planner_tpu.comms.serializer import SecureSerializer, serialize, deserialize
from dart_planner_tpu.comms.zmq_transport import ZmqClient, ZmqServer
from dart_planner_tpu.comms.heartbeat import (
    HeartbeatConfig,
    HeartbeatMessage,
    HeartbeatMonitor,
)
from dart_planner_tpu.comms.telemetry import (
    CompressionType,
    TelemetryCompressor,
    TelemetryPacket,
)

__all__ = [
    "SecureSerializer",
    "serialize",
    "deserialize",
    "ZmqClient",
    "ZmqServer",
    "HeartbeatConfig",
    "HeartbeatMessage",
    "HeartbeatMonitor",
    "CompressionType",
    "TelemetryCompressor",
    "TelemetryPacket",
]
