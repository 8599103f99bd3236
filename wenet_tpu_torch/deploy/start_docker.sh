#!/usr/bin/env bash
#
# Host-side container launcher of the port (counterpart of
# deploy/start_docker.sh): edit the variables (or export them) and run.
# The container gets the card with --gpus all (the NVIDIA container
# toolkit on the host); supervision comes from --restart=always.
set -euo pipefail
MYCALL="${MYCALL:-N0CALL}"
RXFREQ="${RXFREQ:-443500000}"
GAIN="${GAIN:-0}"
BAUD_RATE="${BAUD_RATE:-115177}"
OVERSAMPLING="${OVERSAMPLING:-8}"
IMAGE="${IMAGE:-wenet-tpu-torch:latest}"
docker build -t "$IMAGE" -f "$(dirname "$0")/Dockerfile" "$(dirname "$0")/../.."
exec docker run -d --restart=always --name wenet-rx --gpus all \
    --device /dev/bus/usb \
    -e MYCALL="$MYCALL" -e RXFREQ="$RXFREQ" -e GAIN="$GAIN" \
    -e BAUD_RATE="$BAUD_RATE" -e OVERSAMPLING="$OVERSAMPLING" \
    -p 5003:5003 -p 7890:7890/udp -p 55672:55672/udp \
    "$IMAGE"
