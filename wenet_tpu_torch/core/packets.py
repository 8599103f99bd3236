"""Wenet application-layer packet formats: generators and decoders.

Wire-format truth mirrored from rx/WenetPackets.py (type registry :28-41,
SSDV header :74-123, text :137-159, GPS 73B :177-299, orientation 43B
:340-407, image telemetry 80B :443-563, secondary :590-602) and the TX
generators in tx/PacketTX.py (:231-476).
"""
from __future__ import annotations

import datetime
import struct
import traceback

WENET_IMAGE_UDP_PORT = 7890
WENET_TELEMETRY_UDP_PORT = 55672
WENET_TX_UDP_PORT = 55674


class PacketType:
    TEXT_MESSAGE = 0x00
    GPS_TELEMETRY = 0x01
    ORIENTATION_TELEMETRY = 0x02
    SEC_PAYLOAD_TELEMETRY = 0x03
    IMAGE_TELEMETRY = 0x54
    SSDV = 0x55
    IDLE = 0x56


class PacketLength:
    GPS_TELEMETRY = 73
    ORIENTATION_TELEMETRY = 43
    IMAGE_TELEMETRY = 80


GPS_STRUCT = ">BHIBffffffBBBffHfffffff"
ORIENTATION_STRUCT = ">BHIBBBBBBBbfffffff"
IMAGE_TELEM_STRUCT = ">BH7pBHIBffffffBBBBBBBBBbfffffff"

_GPS_FIX = {0: "No Fix", 2: "2D Fix", 3: "3D Fix", 5: "Time Only"}
_DYNAMIC_MODEL = {
    0: "Portable", 1: "Not Used", 2: "Stationary", 3: "Pedestrian",
    4: "Automotive", 5: "Sea", 6: "Airborne 1G", 7: "Airborne 2G",
    8: "Airborne 4G",
}


def decode_packet_type(packet) -> int:
    return bytes(bytearray(packet))[0]


def gps_weeksecondstoutc_dt(gpsweek, gpsseconds,
                            leapseconds) -> "datetime.datetime":
    """GPS week/seconds-in-week -> UTC datetime (leap seconds removed)."""
    epoch = datetime.datetime(1980, 1, 6)
    return epoch + datetime.timedelta(days=gpsweek * 7,
                                      seconds=gpsseconds - leapseconds)


def gps_weeksecondstoutc(gpsweek, gpsseconds, leapseconds) -> str:
    return gps_weeksecondstoutc_dt(gpsweek, gpsseconds, leapseconds).isoformat()


# ------------------------------------------------------------------ SSDV

_SSDV_CALLSIGN_ALPHABET = "-0123456789---ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def ssdv_decode_callsign(code) -> str:
    value = struct.unpack(">I", bytes(bytearray(code)))[0]
    callsign = ""
    while value:
        callsign += _SSDV_CALLSIGN_ALPHABET[value % 40]
        value //= 40
    return callsign


def ssdv_encode_callsign(callsign: str) -> bytes:
    value = 0
    for ch in reversed(callsign.upper()):
        value = value * 40 + _SSDV_CALLSIGN_ALPHABET.index(ch)
    return struct.pack(">I", value)


def ssdv_packet_info(packet) -> dict:
    packet = list(bytearray(packet))
    if len(packet) != 256:
        return {"error": "ERROR: Invalid Packet Length"}
    if packet[0] != 0x55:
        return {"error": "ERROR: Not a SSDV Packet."}
    try:
        return {
            "callsign": ssdv_decode_callsign(packet[2:6]),
            "packet_type": "FEC" if packet[1] == 0x66 else "No-FEC",
            "image_id": packet[6],
            "packet_id": (packet[7] << 8) + packet[8],
            "width": packet[9] * 16,
            "height": packet[10] * 16,
            "error": "None",
        }
    except Exception as e:  # pragma: no cover
        traceback.print_exc()
        return {"error": "ERROR: %s" % str(e)}


def ssdv_packet_string(packet) -> str:
    info = ssdv_packet_info(packet)
    if info["error"] != "None":
        return "SSDV: Unable to decode."
    return "SSDV: %s, Callsign: %s, Img:%d, Pkt:%d, %dx%d" % (
        info["packet_type"], info["callsign"], info["image_id"],
        info["packet_id"], info["width"], info["height"])


# ------------------------------------------------------------------ text

def encode_text_message(message: str, count: int) -> bytes:
    message = message[:252]
    return b"\x00" + struct.pack(">BH", len(message), count) + message.encode("ascii")


def decode_text_message(packet) -> dict:
    packet = bytes(bytearray(packet))
    try:
        length = packet[1]
        mid = struct.unpack(">H", packet[2:4])[0]
        return {"len": length, "id": mid,
                "text": packet[4:4 + length].decode("ascii"), "error": "None"}
    except Exception:
        return {"error": "Could not decode message packet."}


def text_message_string(packet) -> str:
    m = decode_text_message(packet)
    if m["error"] != "None":
        return "Text: ERROR Could not decode."
    return "Text Message #%d: \t%s" % (m["id"], m["text"])


# ------------------------------------------------------------------ GPS

def encode_gps_telemetry(gps: dict) -> bytes:
    """Pack the 0x01 GPS telemetry packet (PacketTX.transmit_gps_telemetry)."""
    return struct.pack(
        GPS_STRUCT, 1,
        gps["week"], int(gps["iTOW"] * 1000), gps["leapS"],
        gps["latitude"], gps["longitude"], gps["altitude"],
        gps["ground_speed"], gps["heading"], gps["ascent_rate"],
        gps["numSV"], gps["gpsFix"], gps["dynamic_model"],
        gps.get("radio_temp", -999.0), gps.get("cpu_temp", -999.0),
        int(gps.get("cpu_speed", 0)),
        gps.get("load_avg_1", 0.0), gps.get("load_avg_5", 0.0),
        gps.get("load_avg_15", 0.0), gps.get("disk_percent", -1.0),
        gps.get("lens_position", -999.0), gps.get("sensor_temp", -999.0),
        gps.get("focus_fom", -999.0))


def gps_telemetry_decoder(packet) -> dict:
    packet = bytes(bytearray(packet))
    if len(packet) < PacketLength.GPS_TELEMETRY:
        return {"error": "GPS Telemetry Packet has invalid length."}
    packet = packet[:PacketLength.GPS_TELEMETRY]
    try:
        d = struct.unpack(GPS_STRUCT, packet)
        gps = {
            "week": d[1], "iTOW": d[2] / 1000.0, "leapS": d[3],
            "latitude": d[4], "longitude": d[5], "altitude": d[6],
            "ground_speed": d[7], "heading": d[8], "ascent_rate": d[9],
            "numSV": d[10], "gpsFix": d[11], "dynamic_model": d[12],
            "radio_temp": round(d[13], 1), "cpu_temp": round(d[14], 1),
            "cpu_speed": d[15], "load_avg_1": round(d[16], 3),
            "load_avg_5": round(d[17], 3), "load_avg_15": round(d[18], 3),
            "disk_percent": round(d[19], 3), "lens_position": round(d[20], 4),
            "sensor_temp": round(d[21], 1), "focus_fom": int(d[22]),
        }
        if gps["cpu_speed"] == 21845:  # 0x5555 padding => pre-2024 transmitter
            gps.update(radio_temp=-999.0, cpu_temp=-999.0, cpu_speed=0,
                       load_avg_1=0, load_avg_5=0, load_avg_15=0,
                       disk_percent=-1.0, lens_position=-999.0,
                       sensor_temp=-999.0, focus_fom=-999.0)
        gps["timestamp"] = gps_weeksecondstoutc(gps["week"], gps["iTOW"], gps["leapS"])
        gps["gpsFix_str"] = _GPS_FIX.get(gps["gpsFix"], "Unknown (%d)" % gps["gpsFix"])
        gps["dynamic_model_str"] = _DYNAMIC_MODEL.get(gps["dynamic_model"], "Unknown")
        gps["error"] = "None"
        return gps
    except Exception:
        traceback.print_exc()
        return {"error": "Could not decode GPS telemetry packet."}


def gps_telemetry_string(packet) -> str:
    g = gps_telemetry_decoder(packet)
    if g["error"] != "None":
        return "GPS: ERROR Could not decode."
    return ("GPS: %s Lat/Lon: %.5f,%.5f Alt: %dm, Speed: H %dkph V %.1fm/s, "
            "Heading: %d deg, Fix: %s, SVs: %d, DynModel: %s") % (
        g["timestamp"], g["latitude"], g["longitude"], int(g["altitude"]),
        int(g["ground_speed"]), g["ascent_rate"], int(g["heading"]),
        g["gpsFix_str"], g["numSV"], g["dynamic_model_str"])


# ------------------------------------------------------------- orientation

def encode_orientation_telemetry(week, iTOW, leapS, o: dict) -> bytes:
    return struct.pack(
        ORIENTATION_STRUCT, 2, week, int(iTOW * 1000), leapS,
        o["sys_status"], o["sys_error"], o["sys_cal"], o["gyro_cal"],
        o["accel_cal"], o["magnet_cal"], o["temp"],
        o["euler_heading"], o["euler_roll"], o["euler_pitch"],
        o["quaternion_x"], o["quaternion_y"], o["quaternion_z"],
        o["quaternion_w"])


def orientation_telemetry_decoder(packet) -> dict:
    packet = bytes(bytearray(packet))
    if len(packet) < PacketLength.ORIENTATION_TELEMETRY:
        return {"error": "Orientation Telemetry Packet has invalid length."}
    packet = packet[:PacketLength.ORIENTATION_TELEMETRY]
    try:
        d = struct.unpack(ORIENTATION_STRUCT, packet)
        o = {"week": d[1], "iTOW": d[2] / 1000.0, "leapS": d[3]}
        o["timestamp"] = gps_weeksecondstoutc(o["week"], o["iTOW"], o["leapS"])
        (o["sys_status"], o["sys_error"], o["sys_cal"], o["gyro_cal"],
         o["accel_cal"], o["magnet_cal"], o["temp"]) = d[4:11]
        (o["euler_heading"], o["euler_roll"], o["euler_pitch"]) = d[11:14]
        (o["quaternion_x"], o["quaternion_y"], o["quaternion_z"],
         o["quaternion_w"]) = d[14:18]
        o["error"] = "None"
        return o
    except Exception:
        traceback.print_exc()
        return {"error": "Could not decode Orientation telemetry packet."}


# ------------------------------------------------------------ image telem

def encode_image_telemetry(gps: dict, orientation: dict, image_id: int,
                           callsign: str, count: int) -> bytes:
    return struct.pack(
        IMAGE_TELEM_STRUCT, 0x54, count, callsign.encode(), image_id,
        gps["week"], int(gps["iTOW"] * 1000), gps["leapS"],
        gps["latitude"], gps["longitude"], gps["altitude"],
        gps["ground_speed"], gps["heading"], gps["ascent_rate"],
        gps["numSV"], gps["gpsFix"], gps["dynamic_model"],
        orientation["sys_status"], orientation["sys_error"],
        orientation["sys_cal"], orientation["gyro_cal"],
        orientation["accel_cal"], orientation["magnet_cal"],
        orientation["temp"], orientation["euler_heading"],
        orientation["euler_roll"], orientation["euler_pitch"],
        orientation["quaternion_x"], orientation["quaternion_y"],
        orientation["quaternion_z"], orientation["quaternion_w"])


def image_telemetry_decoder(packet) -> dict:
    packet = bytes(bytearray(packet))
    if len(packet) < PacketLength.IMAGE_TELEMETRY:
        return {"error": "Image Telemetry Packet has invalid length."}
    packet = packet[:PacketLength.IMAGE_TELEMETRY]
    try:
        d = struct.unpack(IMAGE_TELEM_STRUCT, packet)
        img = {
            "sequence_number": d[1], "callsign": d[2].decode(),
            "image_id": d[3], "week": d[4], "iTOW": d[5] / 1000.0,
            "leapS": d[6], "latitude": d[7], "longitude": d[8],
            "altitude": d[9], "ground_speed": d[10], "heading": d[11],
            "ascent_rate": d[12], "numSV": d[13], "gpsFix": d[14],
            "dynamic_model": d[15],
        }
        img["timestamp"] = gps_weeksecondstoutc(img["week"], img["iTOW"], img["leapS"])
        img["gpsFix_str"] = _GPS_FIX.get(img["gpsFix"], "Unknown (%d)" % img["gpsFix"])
        img["dynamic_model_str"] = _DYNAMIC_MODEL.get(img["dynamic_model"], "Unknown")
        (img["sys_status"], img["sys_error"], img["sys_cal"], img["gyro_cal"],
         img["accel_cal"], img["magnet_cal"], img["temp"]) = d[16:23]
        (img["euler_heading"], img["euler_roll"], img["euler_pitch"]) = d[23:26]
        (img["quaternion_x"], img["quaternion_y"], img["quaternion_z"],
         img["quaternion_w"]) = d[26:30]
        img["error"] = "None"
        return img
    except Exception:
        traceback.print_exc()
        return {"error": "Could not decode Image telemetry packet."}


# --------------------------------------------------------------- secondary

def encode_sec_payload(payload_id: int, data: bytes) -> bytes:
    return b"\x03" + struct.pack(">B", int(payload_id) % 256) + bytes(data)[:254]


def sec_payload_decode(packet) -> dict:
    packet = bytes(bytearray(packet))
    try:
        return {"id": packet[1], "payload": packet[2:]}
    except Exception:
        return {"error": "Could not decode secondary payload packet."}


# ------------------------------------------------------ habitat (legacy)

def crc16_ccitt_hex(data: bytes) -> str:
    """Upper-hex CRC16/CCITT-FALSE, as the reference's crc16_ccitt
    (WenetPackets.py:635-642) returns for UKHAS sentence checksums."""
    from .framing import crc16_ccitt
    return "%04X" % crc16_ccitt(data)


def image_telemetry_habitat_string(packet) -> str:
    """UKHAS-standard sentence for an image-telemetry packet
    (WenetPackets.py:645-683)."""
    d = image_telemetry_decoder(packet)
    if d["error"] != "None":
        return "Image Telemetry: ERROR Could not decode."
    epoch = datetime.datetime.strptime("1980-01-06 00:00:00", "%Y-%m-%d %H:%M:%S")
    elapsed = datetime.timedelta(days=d["week"] * 7, seconds=d["iTOW"])
    timestamp = epoch + elapsed - datetime.timedelta(seconds=d["leapS"])
    sentence = "$$%s,%d,%s,%.5f,%.5f,%d,%d,%d,%d,%.2f,%.2f,%.2f,%.5f,%.5f,%.5f,%.5f" % (
        d["callsign"], d["sequence_number"], timestamp.strftime("%H:%M:%S"),
        d["latitude"], d["longitude"], d["altitude"], d["numSV"],
        d["image_id"], d["sys_cal"], d["euler_heading"], d["euler_roll"],
        d["euler_pitch"], d["quaternion_x"], d["quaternion_y"],
        d["quaternion_z"], d["quaternion_w"])
    return sentence + "*" + crc16_ccitt_hex(sentence[2:].encode("ascii")) + "\n"


def image_telemetry_upload(packet, user_callsign: str = "N0CALL",
                           upload_retries: int = 5, upload_timeout: int = 10,
                           put=None):
    """Legacy Habitat payload_telemetry upload (WenetPackets.py:687-751).

    The service is defunct; kept for API parity. `put(url, data, timeout)`
    is injectable (returns an object with .status_code) so tests never touch
    the network; without it, `requests.put` is used.
    """
    import json
    from base64 import b64encode
    from hashlib import sha256

    sentence = image_telemetry_habitat_string(packet)
    _b64 = b64encode(sentence.encode("ascii"))
    _date = datetime.datetime.now(datetime.timezone.utc).replace(
        tzinfo=None).isoformat("T") + "Z"
    data = json.dumps({
        "type": "payload_telemetry",
        "data": {"_raw": _b64.decode("ascii")},
        "receivers": {user_callsign: {"time_created": _date,
                                      "time_uploaded": _date}},
    })
    url = ("http://habitat.habhub.org/habitat/_design/payload_telemetry/"
           "_update/add_listener/%s" % sha256(_b64).hexdigest())
    if put is None:                                        # pragma: no cover
        import requests
        put = lambda u, d, timeout: requests.put(u, data=d, timeout=timeout)
    for _ in range(upload_retries):
        try:
            req = put(url, data, timeout=upload_timeout)
        except Exception as e:
            return (False, "Failed to upload to Habitat: %s" % str(e))
        if req.status_code in (201, 403):
            return (True, "Image Telemetry: Uploaded to Habitat Successfuly.")
        if req.status_code != 409:      # 409 = conflict, retry; else give up
            return (False, "Failed to upload to Habitat: status %d"
                    % req.status_code)
    return (False, "Failed to upload to Habitat after %d retries."
            % upload_retries)


# ---------------------------------------------------------------- dispatch

def packet_to_string(packet) -> str:
    ptype = decode_packet_type(packet)
    if ptype == PacketType.TEXT_MESSAGE:
        return text_message_string(packet)
    if ptype == PacketType.GPS_TELEMETRY:
        return gps_telemetry_string(packet)
    if ptype == PacketType.ORIENTATION_TELEMETRY:
        o = orientation_telemetry_decoder(packet)
        if o["error"] != "None":
            return "Orientation: ERROR Could not decode."
        return "Orientation: %s Temp: %d Euler: (%.1f,%.1f,%.1f)" % (
            o["timestamp"], o["temp"], o["euler_heading"], o["euler_roll"],
            o["euler_pitch"])
    if ptype == PacketType.SEC_PAYLOAD_TELEMETRY:
        sec = sec_payload_decode(packet)
        if "error" in sec:
            return "Secondary Payload Packet: Error - Could not Decode."
        return "Secondary Payload Packet (ID: #%d)" % sec["id"]
    if ptype == PacketType.IMAGE_TELEMETRY:
        i = image_telemetry_decoder(packet)
        if i["error"] != "None":
            return "Image Telemetry: ERROR Could not decode."
        return "Image Telemetry: %s ID #%d" % (i["callsign"], i["image_id"])
    if ptype == PacketType.SSDV:
        return ssdv_packet_string(packet)
    return "Unknown Packet Type: %d" % ptype
