#!/usr/bin/env bash
#
# Payload TX entrypoint of the PyTorch/CUDA port, the counterpart of
# deploy/start_tx.sh (same edit-the-header variables, start_tx.sh:10-60):
# camera -> SSDV -> framing -> radio, choosing the I2S (v2) or UART (v1)
# modulation transport.  The flight side is host code: it needs no card.
set -euo pipefail
MYCALL="${MYCALL:-N0CALL}"
TX_MODE="${TX_MODE:-v2}"              # v2 = I2S 96000 baud, v1 = UART 115177
IMAGES_DIR="${IMAGES_DIR:-/tmp/wenet_images}"
GPS_PORT="${GPS_PORT:-}"              # e.g. /dev/ttyACM0; empty = no GPS
ALSA_DEVICE="${ALSA_DEVICE:-hw:CARD=sndrpihifiberry,DEV=0}"
UART_PORT="${UART_PORT:-/dev/ttyAMA0}"
RESOLUTION="${RESOLUTION:-800x608}"
DURATION="${DURATION:-0}"             # seconds; 0 = run forever
# Wait for the SPI bus (the radio) to appear, as start_tx.sh:58-74 does.
for _ in $(seq 1 30); do
    [ -e /dev/spidev0.0 ] && break
    echo "waiting for /dev/spidev0.0 ..." >&2
    sleep 2
done
if [ "$TX_MODE" = "v1" ]; then
    OUT="serial:${UART_PORT}"
else
    OUT="alsa:${ALSA_DEVICE}"
fi
GPS_ARGS=()
if [ -n "$GPS_PORT" ]; then GPS_ARGS+=(--gps-port "$GPS_PORT"); fi
mkdir -p "$IMAGES_DIR"
# --duration is always passed: the flight CLI treats 0 as run-until-killed
exec python3 -m wenet_tpu_torch flight \
    --callsign "$MYCALL" --mode "$TX_MODE" \
    --images-dir "$IMAGES_DIR" --out "$OUT" \
    --tx-resolution "$RESOLUTION" --duration "$DURATION" \
    "${GPS_ARGS[@]}"
